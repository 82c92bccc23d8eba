"""CBAA consensus rounds per trial-auction, from the device counters
(`telemetry='on'` in the traced run): assign_rounds over auctions."""

NEEDS_TELEMETRY = True


def read(r):
    tel = r.telemetry
    if not tel:
        return None
    auctions = float(sum(tel["auctions"]))
    return float(sum(tel["assign_rounds"])) / auctions if auctions else None

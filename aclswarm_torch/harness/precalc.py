"""Precompute formation gains into a formations.yaml library (port of
`aclswarm_tpu/harness/precalc.py`).

The reference ships precomputed gains inside `formations.yaml` so vehicles
don't redo the ADMM solve on formation dispatch (`operator.py:186-197`,
MATLAB `precalc_gains.m`). This tool does the same for the port's copy of
the library: every formation in every group gets a `gains` entry designed
by the port's ADMM solver in float64, validated against the
eigenstructure self-check (`aclswarm/src/aclswarm/control.py:221-261`).

Usage:
    python -m aclswarm_torch.harness.precalc [--library PATH]
        [--group NAME] [--device cpu]

The design runs on the CUDA card unless ``--device`` names another device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import yaml

from aclswarm_torch import gains as gainslib
from aclswarm_torch.harness import formations as formlib

# yaml.safe_dump drops file comments, so the library's format header is
# re-written explicitly on every regeneration. Byte for byte the
# reference's: the port's library is held equal to the reference's file.
HEADER = """\
# aclswarm_tpu formation library (REGENERATED — edits to comments are lost).
#
# Same file format as the reference's `aclswarm/param/formations.yaml:1-8`:
# groups keyed by name, each with `agents`, optional `adjmat` ('fc' or an
# n x n matrix; a group-level key overrides per-formation ones), and a list
# of formations {name, points (n x 3), optional scale, optional adjmat,
# optional gains (3n x 3n)}. Gains are generated by the ADMM solver — run
# `python -m aclswarm_tpu.harness.precalc` to (re)populate them.
#
# Provenance: the demo formation *point geometry* (swarm4 Square spacing,
# swarm6_3d Pentagonal Pyramid coordinates) is reused from the reference's
# `aclswarm/param/formations.yaml` so parity runs compare like-for-like;
# gains are NOT reused — they are designed by this framework's own solver.
# Generated groups (simform*, mitacl-scale) are this framework's own.

"""


def precalc(library_path=None, group: str | None = None,
            verbose: bool = True, device=None) -> list[dict]:
    """Design, validate and write the gains of every formation of
    ``group`` (None = every group) in ``library_path`` (None = the port's
    library), in float64 on ``device`` (None = the CUDA card). Groups
    with ``precalc_gains: false`` are skipped. Raises `RuntimeError` on a
    design that fails the eigenstructure check (the file is then left as
    it was). Returns one record per design: group, name, design ms and the
    validation flags."""
    path = library_path or formlib.DEFAULT_LIBRARY
    with open(path) as f:
        lib = yaml.safe_load(f)

    groups = [group] if group else [k for k, v in lib.items()
                                    if isinstance(v, dict)]
    designs = []
    for g in groups:
        if not lib[g].get("precalc_gains", True):
            # scale groups ship no gains (solved on dispatch instead,
            # `coordination_ros.cpp:112-119`) — the reference's mitacl100
            # pattern
            if verbose:
                print(f"{g}: precalc_gains=false, skipped")
            continue
        specs = formlib.load_group(path, g)
        for spec, raw in zip(specs, lib[g]["formations"]):
            t0 = time.perf_counter()
            A = gainslib.solve_gains(np.asarray(spec.points, np.float64),
                                     spec.adjmat, device=device)
            A = A.detach().cpu().numpy()
            ms = (time.perf_counter() - t0) * 1e3
            v = gainslib.validate_gains(A, spec.points)
            ok = v["no_positive"] and v["kernel_ok"] \
                and v["strictly_negative_rest"]
            if verbose:
                print(f"{g}/{spec.name}: gains {A.shape} "
                      f"{'OK' if ok else 'EIGENSTRUCTURE FAILED'}")
            if not ok:
                raise RuntimeError(
                    f"gain design failed validation for {g}/{spec.name}: "
                    f"{v['eigenvalues']}")
            raw["gains"] = [[round(float(x), 12) for x in row] for row in A]
            designs.append({"group": g, "name": spec.name, "n": spec.n,
                            "ms": ms, "gains": A,
                            **{k: v[k] for k in ("no_positive", "kernel_ok",
                                                 "strictly_negative_rest")}})

    with open(path, "w") as f:
        f.write(HEADER)
        yaml.safe_dump(lib, f, sort_keys=False, default_flow_style=None,
                       width=10000)
    if verbose:
        print(f"wrote {path}")
    return designs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--library", default=None, help="formations.yaml path")
    ap.add_argument("--group", default=None, help="only this group")
    ap.add_argument("--device", default=None,
                    help="device to design on (default: the CUDA card)")
    args = ap.parse_args(argv)
    # library gains are an offline artifact: designed in float64 (the
    # reference precomputes in MATLAB f64 likewise, `precalc_gains.m`);
    # f32 leaves ~1e-4 kernel residue that trips the eigenstructure
    # validation on sparse graphs
    precalc(args.library, args.group, device=args.device)


if __name__ == "__main__":
    main()

"""JC006 fixture: unmasked reductions in fault-aware code.

This file is not under the fault-aware module prefixes, so it opts in:
# torchcheck: fault-aware-file
"""
import torch


def masked_ok(q, alive):
    dn = torch.where(alive, torch.linalg.norm(q, dim=-1), 0.0)
    return torch.sum(dn)                # ok: alive feeds the operand


def transitively_ok(cost, alive):
    pinned = torch.where(alive[:, None], cost, 0.0)
    scores = pinned * 2.0
    return scores.min()                 # ok: alive reaches via two hops


def rebinding_ok(cost, pin, forbid):
    cost = cost + 0.0
    cost = torch.where(pin | forbid, 0.0, cost)
    return torch.amax(cost)             # ok: flow-insensitive rebinding


def comprehension_ok(costs, alive):
    masked = torch.where(alive, costs, 0.0)
    return [c.mean() for c in masked]   # ok: the loop binds c from masked


def bad_mean(q, alive):
    return torch.mean(q)                # JC006


def bad_argmin(cost, link_mask):
    idx = torch.argmin(cost, dim=1)     # JC006
    return idx


def bad_method_sum(q, who):
    dead = who < 0
    total = q.sum()                     # JC006
    return torch.where(dead, 0.0, total)


def bad_method_max(q, alive):
    return q.amax(dim=0)                # JC006


def no_mask_in_scope(q):
    return torch.max(q)                 # ok: handles no mask -> exempt


def suppressed_site(q, alive):
    return torch.sum(q)                 # torchcheck: disable=JC006 reason

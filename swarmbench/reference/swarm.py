"""Plain reference of one swarm trial's control tick and of its gain
design's guarantees, written from the upstream semantics (aclswarm's
`localization_ros.cpp`, `auctioneer.cpp`, `distcntrl.cpp`, `colavoid.cpp`,
`safety.cpp`) for one trial at a time, in any dtype and on any device.

It imports nothing of the program under test. Every function takes plain
tensors: positions (n, 3) in vehicle order, a formation's points (n, 3)
and adjacency (n, n) over formation points, an assignment ``v2f`` (n,)
with ``v2f[v]`` the point of vehicle v. The benchmark runs it in float64
as the reference and in a lower precision as the control.
"""
from __future__ import annotations

import math

import torch

AGE_CAP = (1 << 15) - 1     # ages saturate here in the flood's packing
PRICE_EPS = 1e-8            # CBAA's bid regularizer
TAKEOFF_ALT = 1.0           # m above the ground a trial takes off to
FLYING = 2                  # the flight mode of a vehicle in formation


def invert(v2f: torch.Tensor) -> torch.Tensor:
    """``f2v`` with ``f2v[v2f[v]] = v``."""
    out = torch.empty_like(v2f)
    out[v2f.long()] = torch.arange(v2f.shape[0], dtype=v2f.dtype,
                                   device=v2f.device)
    return out


def comm_graph(adj: torch.Tensor, v2f: torch.Tensor,
               self_loop: bool) -> torch.Tensor:
    """Vehicle-space graph: v hears w iff their points are adjacent."""
    idx = v2f.long()
    comm = adj[idx][:, idx] > 0
    if self_loop:
        comm = comm | torch.eye(adj.shape[0], dtype=torch.bool,
                                device=adj.device)
    return comm


# --- mutual localization: timestamped flooding --------------------------

def flood_tick(est: torch.Tensor, age: torch.Tensor, q: torch.Tensor,
               adj: torch.Tensor, v2f: torch.Tensor, tick: int,
               flood_every: int, phases: int, block: int = 32):
    """One tick of every vehicle's estimate table: ages advance, each
    vehicle's own entry is its true position, and the stripe of targets
    due this tick merges from the neighbours: per receiver and target the
    freshest sender wins (the lowest id among equally fresh ones), and
    only if strictly fresher than the receiver's own entry."""
    n = q.shape[0]
    est = est.clone()
    age = age + 1
    d = torch.arange(n, device=q.device)
    est[d, d] = q.to(est.dtype)
    age[d, d] = 0
    width = -(-n // phases)
    gap = flood_every // phases
    slot = tick % flood_every
    if slot % gap:
        return est, age
    lo = min((slot // gap) * width, n - width)
    hi = lo + width
    comm = comm_graph(adj, v2f, self_loop=False)
    a = torch.clamp(age[:, lo:hi], max=AGE_CAP).long()        # (n, w)
    key = (a << 16) | d[:, None]                               # sender-major
    big = torch.iinfo(torch.int64).max
    best = torch.empty((n, hi - lo), dtype=torch.int64, device=q.device)
    for r in range(0, n, block):
        m = comm[r:r + block, :, None]                         # (b, n, 1)
        best[r:r + block] = torch.where(m, key[None], big).amin(dim=1)
    has = best != big
    best_age = torch.where(has, best >> 16, big)
    take = best_age < a
    src = torch.where(take, best & 0xFFFF, 0)
    new_est = torch.where(take[..., None],
                          est[:, lo:hi][src, torch.arange(hi - lo,
                                                          device=q.device)],
                          est[:, lo:hi])
    est[:, lo:hi] = new_est
    age[:, lo:hi] = torch.where(take, best_age, age[:, lo:hi].long()).to(
        age.dtype)
    return est, age


def relative_views(est: torch.Tensor) -> torch.Tensor:
    """rel[v, w] = v's estimate of w's position minus its own."""
    d = torch.arange(est.shape[0], device=est.device)
    return est - est[d, d][:, None, :]


# --- assignment ---------------------------------------------------------

def _rotation2(s00, s01, s10, s11):
    """The rotation about z maximizing tr(R^T sigma) of a 2x2 sigma."""
    ang = torch.atan2(s10 - s01, s00 + s11)
    return torch.cos(ang), torch.sin(ang)


def align_global(points: torch.Tensor, q: torch.Tensor,
                 v2f: torch.Tensor) -> torch.Tensor:
    """The formation rotated about z and translated onto the swarm in the
    least-squares sense (Arun's method in the plane), each point paired
    with the vehicle now assigned to it; z passes through."""
    qf = q[invert(v2f).long()][:, :2]
    p = points[:, :2]
    mp, mq = p.mean(0), qf.mean(0)
    pc, qc = p - mp, qf - mq
    s = qc.T @ pc / p.shape[0]          # s[i, j] = mean qc_i pc_j
    c, sn = _rotation2(s[0, 0], s[0, 1], s[1, 0], s[1, 1])
    R = torch.stack([torch.stack([c, -sn]), torch.stack([sn, c])])
    t = mq - R @ mp
    xy = p @ R.T + t
    return torch.cat([xy, points[:, 2:3]], dim=1)


def distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j|| by direct subtraction."""
    return torch.linalg.vector_norm(a[:, None, :] - b[None, :, :], dim=-1)


def sinkhorn_plan(cost: torch.Tensor, tau: float, iters: int
                  ) -> torch.Tensor:
    """Log-domain Sinkhorn with uniform marginals, f then g each
    iteration; returns the log plan logK + f + g."""
    n = cost.shape[0]
    logK = -cost / tau
    log_mu = -math.log(n)
    f = torch.zeros(n, dtype=cost.dtype, device=cost.device)
    g = torch.zeros_like(f)
    for _ in range(iters):
        f = log_mu - torch.logsumexp(logK + g[None, :], dim=1)
        g = log_mu - torch.logsumexp(logK + f[:, None], dim=0)
    return logK + f[:, None] + g[None, :]


def greedy_round(plan: torch.Tensor) -> torch.Tensor:
    """Greedy rounding: repeatedly take the largest entry (the first in
    row-major order among equals) and strike its row and column. Run as
    rounds of mutually best pairs, which under that total order is the
    same matching."""
    n = plan.shape[0]
    s = plan.clone()
    out = torch.full((n,), -1, dtype=torch.int64, device=plan.device)
    rows = torch.arange(n, device=plan.device)
    free_r = torch.ones(n, dtype=torch.bool, device=plan.device)
    free_c = torch.ones(n, dtype=torch.bool, device=plan.device)
    neg = torch.tensor(-math.inf, dtype=plan.dtype, device=plan.device)
    while bool(free_r.any()):
        s = torch.where(free_r[:, None] & free_c[None, :], s, neg)
        rbest = torch.argmax(s, dim=1)              # first max in the row
        cbest = torch.argmax(s, dim=0)              # first max in the column
        mutual = free_r & (cbest[rbest] == rows)
        if not bool(mutual.any()):                  # rows left, all -inf
            left_r = rows[free_r]
            left_c = torch.arange(n, device=plan.device)[free_c]
            out[left_r] = left_c
            break
        out[mutual] = rbest[mutual]
        free_r = free_r & ~mutual
        free_c[rbest[mutual]] = False
    return out


def two_opt(cost: torch.Tensor, v2f: torch.Tensor, sweeps: int
            ) -> torch.Tensor:
    """Parallel 2-opt: each sweep every vehicle finds its best swap
    partner (first on ties), and mutually best pairs whose swap saves
    more than 1e-7 swap at once."""
    n = cost.shape[0]
    idx = torch.arange(n, device=cost.device)
    eye = torch.eye(n, dtype=torch.bool, device=cost.device)
    v2f = v2f.long()
    for _ in range(sweeps):
        a = cost[idx, v2f]
        M = cost[:, v2f]                            # M[i, k] = c[i, v2f[k]]
        gain = a[:, None] + a[None, :] - M - M.T
        gain = torch.where(eye, torch.full_like(gain, -math.inf), gain)
        b = torch.argmax(gain, dim=1)
        ok = (b[b] == idx) & (gain[idx, b] > 1e-7)
        v2f = torch.where(ok, v2f[b], v2f)
    return v2f


def align_cost_global(q: torch.Tensor, v2f: torch.Tensor,
                      aligned: torch.Tensor) -> torch.Tensor:
    """The planar least-squares cost the global alignment minimizes."""
    qf = q[invert(v2f).long()][:, :2]
    return ((qf - aligned[:, :2]) ** 2).sum()


def align_cost_local(est: torch.Tensor, adj: torch.Tensor, v2f: torch.Tensor,
                     aligned: torch.Tensor) -> torch.Tensor:
    """Each vehicle's weighted planar least-squares cost that its local
    alignment (n, n, 3) minimizes, (n,)."""
    n = adj.shape[0]
    idx = v2f.long()
    w = ((adj[idx] > 0) | torch.eye(n, dtype=torch.bool,
                                    device=adj.device)[idx]).to(est.dtype)
    qs = est[:, invert(v2f).long(), :2]
    return (w * ((qs - aligned[..., :2]) ** 2).sum(-1)).sum(-1)


def sinkhorn_assign(q: torch.Tensor, points: torch.Tensor, v2f: torch.Tensor,
                    first: bool, eps: float, tau: float = 0.03,
                    iters: int = 200, sweeps: int = 12,
                    aligned: torch.Tensor | None = None) -> dict:
    """The centralized assignment: align (or take ``aligned``), price by
    distance normalized by its mean, Sinkhorn, round, 2-opt, then keep the
    current assignment unless the candidate shortens the total distance by
    ``eps`` (the first auction after a dispatch always takes it)."""
    if aligned is None:
        aligned = align_global(points, q, v2f)
    raw = distances(q, aligned)
    plan = sinkhorn_plan(raw / (raw.mean() + 1e-12), tau, iters)
    cand = two_opt(raw, greedy_round(plan), sweeps)
    keep = v2f.long()
    if eps > 0.0 and not first:
        idx = torch.arange(q.shape[0], device=q.device)
        if not bool(raw[idx, cand].sum() < (1.0 - eps) * raw[idx, keep].sum()):
            cand = keep
    return {"aligned": aligned, "plan": plan, "v2f": cand, "cost": raw}


def align_local(q: torch.Tensor, est: torch.Tensor, points: torch.Tensor,
                adj: torch.Tensor, v2f: torch.Tensor) -> torch.Tensor:
    """Each vehicle's own alignment of the formation (n, n, 3): vehicle v
    at point i weighs point i and i's neighbours, each paired with v's
    estimate of the vehicle assigned to it."""
    n = q.shape[0]
    idx = v2f.long()
    f2v = invert(v2f).long()
    w = ((adj[idx] > 0) | torch.eye(n, dtype=torch.bool,
                                    device=q.device)[idx]).to(points.dtype)
    qs = est[:, f2v, :2]                            # (agent, point, 2)
    p = points[None, :, :2]
    ws = w.sum(1, keepdim=True)
    mp = (w[..., None] * p).sum(1) / ws             # (agent, 2)
    mq = (w[..., None] * qs).sum(1) / ws
    pc = p - mp[:, None, :]
    qc = (qs - mq[:, None, :]) * w[..., None]
    s = torch.einsum("vmi,vmj->vij", qc, pc) / ws[..., None]
    c, sn = _rotation2(s[:, 0, 0], s[:, 0, 1], s[:, 1, 0], s[:, 1, 1])
    tx = mq[:, 0] - (c * mp[:, 0] - sn * mp[:, 1])
    ty = mq[:, 1] - (sn * mp[:, 0] + c * mp[:, 1])
    x = c[:, None] * p[..., 0] - sn[:, None] * p[..., 1] + tx[:, None]
    y = sn[:, None] * p[..., 0] + c[:, None] * p[..., 1] + ty[:, None]
    z = points[None, :, 2].expand(n, n)
    return torch.stack([x, y, z], dim=-1)


def _select(myprice, price, who, ids):
    """Each agent bids on the first task of highest own price among those
    it strictly outbids (and > 0); agents with none change nothing."""
    cand = (myprice > price) & (myprice > 0.0)
    task = torch.argmax(torch.where(cand, myprice, -math.inf), dim=1)
    bid = cand.any(dim=1)
    r = torch.arange(price.shape[0], device=price.device)
    price, who = price.clone(), who.clone()
    price[r[bid], task[bid]] = myprice[r[bid], task[bid]]
    who[r[bid], task[bid]] = ids[bid]
    return price, who


def cbaa(q: torch.Tensor, aligned: torch.Tensor, adj: torch.Tensor,
         v2f: torch.Tensor, block: int = 64) -> dict:
    """The synchronous consensus-based auction: every agent bids its
    nearest aligned point at price 1/(d + 1e-8); each round every agent
    takes, per task, the highest price among its neighbours and itself
    (the lowest vehicle id on ties) and its winner; an agent outbid
    bids again on the merged table; up to 2n rounds, ending at the
    tables' fixed point. Valid iff every agent holds the same winner
    list and it is a permutation."""
    n = q.shape[0]
    dev = q.device
    ids = torch.arange(n, device=dev)
    comm = comm_graph(adj, v2f, self_loop=True)
    myprice = 1.0 / (torch.linalg.vector_norm(q[:, None, :] - aligned,
                                              dim=-1) + PRICE_EPS)
    price = torch.zeros((n, n), dtype=q.dtype, device=dev)
    who = torch.full((n, n), -1, dtype=torch.int64, device=dev)
    price, who = _select(myprice, price, who, ids)
    rounds = 0
    for _ in range(2 * n):
        newp = torch.empty_like(price)
        neww = torch.empty_like(who)
        for s in range(0, n, block):
            pb = price[:, s:s + block]
            eff = torch.where(comm[:, :, None], pb[None], -math.inf)
            best = eff.amax(dim=1)                          # (agent, task)
            sender = torch.where(eff == best[:, None, :], ids[None, :, None],
                                 n).amin(dim=1)
            newp[:, s:s + block] = best
            neww[:, s:s + block] = torch.gather(who[:, s:s + block], 0,
                                                sender)
        outbid = ((who == ids[:, None]) & (neww != ids[:, None])).any(dim=1)
        rp, rw = _select(myprice, newp, neww, ids)
        newp = torch.where(outbid[:, None], rp, newp)
        neww = torch.where(outbid[:, None], rw, neww)
        rounds += 1
        same = torch.equal(newp, price) and torch.equal(neww, who)
        price, who = newp, neww
        if same:
            break
    f2v = who[0]
    valid = bool((who == f2v[None]).all()) and bool(
        torch.sort(f2v).values.eq(ids).all())
    new_v2f = invert(f2v) if valid else v2f.long()
    return {"v2f": new_v2f, "price": price, "who": who, "valid": valid,
            "rounds": rounds, "myprice": myprice}


# --- the control law, avoidance, the safety shim and the vehicle -------

def desired_distances(points: torch.Tensor):
    """(n, n) desired planar and vertical distances between points."""
    dxy = torch.linalg.vector_norm(points[:, None, :2] - points[None, :, :2],
                                   dim=-1)
    dz = torch.abs(points[:, None, 2] - points[None, :, 2])
    return dxy, dz


def gain_blocks(flat: torch.Tensor) -> torch.Tensor:
    """(3n, 3n) gain matrix -> (n, n, 3, 3) blocks G[i, j]."""
    n = flat.shape[0] // 3
    return flat.reshape(n, 3, n, 3).permute(0, 2, 1, 3)


def control_law(vel: torch.Tensor, rel: torch.Tensor, points: torch.Tensor,
                adj: torch.Tensor, gains_flat: torch.Tensor,
                v2f: torch.Tensor, k: dict, tie: float = 0.0):
    """Each vehicle's distributed formation command in vehicle order:
    kp * sum_j a_ij (G_ij q_ij + F_ij q_ij) - kd * deg_i * vel, where
    q_ij is vehicle i's view of point j's vehicle relative to itself, and
    F the deadbanded atan scale term of the planar and vertical ranges.

    With ``tie`` > 0 also returns each vehicle's allowance for deadband
    near-ties: the command's change if every pair whose range error lies
    within ``tie`` of its deadband switched sides, which rounding of the
    desired distances (float32 at 100 m: ~1e-4 m) can flip."""
    f2v = invert(v2f).long()
    qij = rel[f2v][:, f2v]                          # formation order
    dxy, dz = desired_distances(points)
    e_xy = torch.linalg.vector_norm(qij[..., :2], dim=-1) - dxy
    fxy = k["K1_xy"] * torch.atan(k["K2_xy"] * e_xy)
    fxy = torch.where(torch.abs(e_xy) > k["e_xy_thr"], fxy, 0.0)
    e_z = torch.abs(qij[..., 2]) - dz
    fz = k["K1_z"] * torch.atan(k["K2_z"] * e_z)
    fz = torch.where(torch.abs(e_z) > k["e_z_thr"], fz, 0.0)
    F = torch.stack([fxy, fxy, fz], dim=-1)
    lin = torch.einsum("ijab,ijb->ija", gain_blocks(gains_flat), qij)
    a = (adj > 0).to(qij.dtype)
    up = (a[..., None] * (lin + F * qij)).sum(dim=1)
    deg = a.sum(dim=1)
    u = k["kp"] * up[v2f.long()] - k["kd"] * deg[v2f.long()][:, None] * vel
    if tie <= 0.0:
        return u
    jxy = torch.where((torch.abs(e_xy).sub(k["e_xy_thr"]).abs() < tie),
                      torch.abs(k["K1_xy"] * torch.atan(k["K2_xy"] * e_xy)),
                      0.0)
    jz = torch.where((torch.abs(e_z).sub(k["e_z_thr"]).abs() < tie),
                     torch.abs(k["K1_z"] * torch.atan(k["K2_z"] * e_z)), 0.0)
    jump = torch.stack([jxy, jxy, jz], dim=-1) * qij.abs() * a[..., None]
    allow = k["kp"] * jump.sum(dim=1).amax(dim=-1)
    return u, allow[v2f.long()]


def saturate(u: torch.Tensor, s: dict) -> torch.Tensor:
    """Planar speed capped at max_vel_xy (direction kept), |vz| at
    max_vel_z."""
    vxy = torch.linalg.vector_norm(u[:, :2], dim=-1, keepdim=True)
    scale = torch.where(vxy > s["max_vel_xy"],
                        s["max_vel_xy"] / torch.clamp(vxy, min=1e-12), 1.0)
    return torch.cat([u[:, :2] * scale,
                      torch.clamp(u[:, 2:], -s["max_vel_z"], s["max_vel_z"])],
                     dim=1)


def wrap(a: torch.Tensor) -> torch.Tensor:
    """Angles to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def avoid(q: torch.Tensor, u: torch.Tensor, s: dict, k: int | None):
    """The velocity-obstacle shim: each neighbour within d_avoid_thresh
    casts a no-fly sector of half-angle asin(r_keep_out / d) about its
    bearing; a heading inside one turns to the nearest free sector edge
    within 90 degrees, else stops; inside a keep-out violation, the agent
    backs away from its deepest violator at keepout_repulse_vel. With
    ``k``, only the k nearest neighbours in range cast sectors (chosen one
    at a time, nearest first, the lowest index on ties, as the upstream
    picks them). Returns (velocities, avoidance-active flags)."""
    n = q.shape[0]
    qij = q[None, :, :] - q[:, None, :]
    dxy = torch.linalg.vector_norm(qij[..., :2], dim=-1)
    active = (dxy <= s["d_avoid_thresh"]) & ~torch.eye(
        n, dtype=torch.bool, device=q.device)
    if k is not None and k < n - 1:
        dm = torch.where(active, dxy, math.inf)
        picks = []
        for _ in range(k):
            j = torch.argmin(dm, dim=1, keepdim=True)
            dm = dm.scatter(1, j, math.inf)
            picks.append(j)
        idx = torch.cat(picks, dim=1)
        cxy = torch.gather(qij[..., :2], 1, idx[..., None].expand(-1, -1, 2))
        cact = torch.gather(active, 1, idx)
    else:
        cxy, cact = qij[..., :2], active
    rk = s["r_keep_out"]
    d = torch.linalg.vector_norm(cxy, dim=-1)
    theta = torch.atan2(cxy[..., 1], cxy[..., 0])
    alpha = torch.abs(torch.asin(torch.clamp(rk / torch.clamp(d, min=1e-12),
                                             max=1.0)))
    psi = torch.atan2(u[:, 1], u[:, 0])
    inside = cact & (torch.abs(wrap(psi[:, None] - theta)) < alpha)
    unsafe = inside.any(dim=1)
    m = theta.shape[1]
    edges = torch.cat([theta - alpha, theta + alpha], dim=1)      # (n, 2m)
    eact = torch.cat([cact, cact], dim=1)
    own = torch.eye(m, dtype=torch.bool, device=q.device).repeat(2, 1)
    covered = (~own[None] & cact[:, None, :]
               & (torch.abs(wrap(edges[:, :, None] - theta[:, None, :]))
                  < alpha[:, None, :])).any(dim=2)
    free = eact & ~covered
    we = wrap(edges)
    dist = torch.where(free, torch.abs(we - psi[:, None]), math.inf)
    mind = dist.min(dim=1).values
    best = torch.where(dist == mind[:, None], we, -math.inf).max(dim=1).values
    bdist = torch.where(torch.isfinite(mind), torch.abs(wrap(best - psi)),
                        math.inf)
    umag = torch.linalg.vector_norm(u[:, :2], dim=-1)
    vedge = torch.stack([umag * torch.cos(best), umag * torch.sin(best),
                         u[:, 2]], dim=-1)
    ok = torch.isfinite(bdist) & (bdist <= math.pi / 2.0)
    out = torch.where(unsafe[:, None],
                      torch.where(ok[:, None], vedge, torch.zeros_like(u)), u)
    viol = cact & (d < rk)
    anyv = viol.any(dim=1) & (s["keepout_repulse_vel"] > 0.0)
    j = torch.argmin(torch.where(viol, d, math.inf), dim=1)
    r = torch.arange(n, device=q.device)
    away = -cxy[r, j] / torch.clamp(d[r, j], min=1e-9)[:, None]
    rep = min(s["keepout_repulse_vel"], s["max_vel_xy"])
    vrep = torch.cat([rep * away, u[:, 2:3]], dim=-1)
    out = torch.where(anyv[:, None], vrep, out)
    return out, unsafe | anyv


def fly(q, vel, goal: dict, mode, u_safe, s: dict, dt: float,
        kp_track: float = 8.0, kd_track: float = 4.0):
    """The safety shim's trajectory goal from the avoided velocity (each
    axis's change rate-limited by max_accel, integrated, kept in the room
    unless already outside, clamped axes braked; yaw integrated at zero
    rate), taken as the goal of every FLYING vehicle, then the double
    integrator tracking it for one tick. Returns (q, vel, goal, ok): ``ok``
    is False if a vehicle was in another flight mode, which this
    reference does not fly."""
    amax = torch.tensor([s["max_accel_xy"], s["max_accel_xy"],
                         s["max_accel_z"]], dtype=q.dtype, device=q.device)
    v = torch.clamp(u_safe, goal["vel"] - amax * dt, goal["vel"] + amax * dt)
    nxt = goal["pos"] + v * dt
    bmin = torch.tensor(s["bounds_min"], dtype=q.dtype, device=q.device)
    bmax = torch.tensor(s["bounds_max"], dtype=q.dtype, device=q.device)
    lo = torch.minimum(bmin, goal["pos"])
    hi = torch.maximum(bmax, goal["pos"])
    pos = torch.clamp(nxt, lo, hi)
    clamped = (nxt < lo) | (nxt > hi)
    brake = torch.clamp(torch.zeros_like(v), goal["vel"] - amax * dt,
                        goal["vel"] + amax * dt)
    v = torch.where(clamped, brake, v)
    yaw = wrap(goal["yaw"])
    new_goal = {"pos": pos, "vel": v, "yaw": yaw,
                "dyaw": torch.zeros_like(goal["dyaw"])}
    acc = kp_track * (pos - q) + kd_track * (v - vel)
    vel = vel + acc * dt
    return q + vel * dt, vel, new_goal, bool((mode == FLYING).all())


# --- the supervisor's per-chunk observables ----------------------------

def summarize(dn, ca, qs, modes, hist_dn, hist_ca, fx, fy, cum, inited,
              window: int, thr: dict) -> dict:
    """One chunk of one trial, (T, n) per-tick |distcmd|, avoidance flags,
    (T, n, 3) positions and modes, with the trailing (W-1, n) history and
    the EWMA filter state before it: per tick, every vehicle's trailing
    W-tick mean |distcmd| under 1 m/s (converged), any vehicle's trailing
    avoidance duty over 0.95 (gridlock), all vehicles within 0.05 m of the
    takeoff altitude, all FLYING; and each vehicle's planar path length of
    the EWMA-filtered position (alpha 0.98) added up."""
    T = dn.shape[0]
    ext_dn = torch.cat([hist_dn, dn], 0)
    ext_ca = torch.cat([hist_ca, ca.to(dn.dtype)], 0)
    conv, grid = [], []
    # a mean is the window's sum over its length in one correctly rounded
    # division (95 of 100 ticks is 0.95, not above it); a tensor divisor,
    # as a scalar one may be taken as a product with its reciprocal
    w = torch.full((dn.shape[1],), float(window), dtype=ext_dn.dtype,
                   device=dn.device)
    for t in range(T):
        conv.append(bool((ext_dn[t:t + window].sum(0) / w
                          < thr["conv"]).all()))
        grid.append(bool((ext_ca[t:t + window].sum(0) / w
                          > thr["grid"]).any()))
    taken = [bool((torch.abs(qs[t, :, 2] - TAKEOFF_ALT) < thr["zero_pos"])
                  .all()) for t in range(T)]
    flying = [bool((modes[t] == FLYING).all()) for t in range(T)]
    a = thr["ewma"]
    f = torch.stack([fx, fy], -1)
    init = bool(inited)
    for t in range(T):
        xy = qs[t, :, :2]
        nf = a * f + (1 - a) * xy if init else xy
        if init:
            cum = cum + torch.linalg.vector_norm(nf - f, dim=-1)
        f, init = nf, True
    return {"conv_all": conv, "grid_any": grid, "taken_off": taken,
            "all_flying": flying, "cumdist": cum}


# --- the gain design's guarantees ---------------------------------------

def kernel_basis(points: torch.Tensor, planar: bool) -> torch.Tensor:
    """The (3n, 6) directions a formation's gain matrix must annihilate
    (5 for a flat formation): planar translation, rotation about z and
    scale in the plane; vertical translation and scale along z."""
    n = points.shape[0]
    z0 = torch.zeros(n, dtype=points.dtype, device=points.device)
    one = torch.ones_like(z0)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    cols = [(x, y, z0), (-y, x, z0), (one, z0, z0), (z0, one, z0),
            (z0, z0, z)]
    if not planar:
        cols.append((z0, z0, one))
    N = torch.stack([torch.stack(c, dim=1).reshape(-1) for c in cols], 1)
    return N / torch.linalg.vector_norm(N, dim=0, keepdim=True)


def gain_report(A: torch.Tensor, points: torch.Tensor, adj: torch.Tensor,
                thr_planar: float = 1e-2) -> dict:
    """What a designed gain matrix (before its gain scale) must satisfy:
    it annihilates the formation's similarity directions (``kernel``:
    ||A N|| / ||A||), no entry is nonzero between points the graph does
    not join (``offgraph``: a count), its trace is the design's (the
    trace of its normalized blocks; ``trace``: the relative gap), and it
    is negative definite off those directions (``indefinite``: 1 where
    -A + N N^T, N an orthonormal kernel basis, has no Cholesky factor)."""
    planar = bool(torch.std(points[:, 2]) < thr_planar)
    N = kernel_basis(points, planar)
    kern = float(torch.linalg.matrix_norm(A @ N)
                 / torch.linalg.matrix_norm(A))
    n = points.shape[0]
    allowed = (adj > 0) | torch.eye(n, dtype=torch.bool, device=A.device)
    blocks = gain_blocks(A)
    off = int(((blocks != 0) & ~allowed[:, :, None, None]).sum())
    want = -float(2 * n - 4 + (n - 1 if planar else n - 2))
    tr = abs(float(torch.trace(A)) / want - 1.0)
    No = torch.linalg.qr(N).Q
    M = -0.5 * (A + A.T) + No @ No.T
    indef = int(torch.linalg.cholesky_ex(M).info.item() != 0)
    return {"kernel": kern, "offgraph": off, "trace": tr,
            "indefinite": indef}

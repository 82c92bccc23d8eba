"""JAX's threefry random stream as torch integer ops (the port's copy of
what the reference draws through `jax.random`: `jax/_src/prng.py` and
`jax/_src/random.py` of JAX 0.9.0, with ``jax_threefry_partitionable`` on,
its default).

The reference seeds per-tick draws with ``fold_in(key, tick)`` and draws
uniforms (the fault model's link loss) and normals (the scenario's
byzantine lie, gusts and sensor noise). A torch generator cannot reproduce
them, so the hash is written out:

- a key is its two uint32 words, held in an int64 tensor ``(..., 2)``: a
  batch of B per-trial keys is one ``(B, 2)`` tensor, and every function
  here hashes the whole batch at once;
- uint32 arithmetic is int64 arithmetic masked to 32 bits after every add
  and left shift, so every right shift is the logical shift JAX makes;
- uniforms are integer bits plus one float subtraction and equal JAX's bit
  for bit; normals go through XLA's own ``erf_inv`` polynomials (Giles'
  single- and double-precision forms), not `torch.special.erfinv`, and
  still differ from XLA's by a few ulp, which come from ``log1p``
  (`tests/test_torch_prng.py` states the tolerance).

Plain torch on both devices: there is no Pallas kernel behind any of it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(key: torch.Tensor, x0, x1
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the count words ``(x0, x1)`` under
    ``key`` (``(..., 2)``; the words broadcast against ``key[..., 0]``).
    Returns the two hashed words as int64 tensors in [0, 2^32)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (ks[0] + x0) & MASK32
    x1 = (ks[1] + x1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """JAX's ``prng.threefry_2x32(keypair, count)`` for one (2,) key: the
    flat counts split in halves (an odd count padded with a 0), hashed
    pairwise, concatenated back to ``count``'s shape."""
    flat = count.reshape(-1).to(torch.int64)
    odd = flat.numel() % 2
    if odd:
        flat = torch.cat([flat, flat.new_zeros(1)])
    h = flat.numel() // 2
    y0, y1 = threefry2x32(key, flat[:h], flat[h:])
    out = torch.cat([y0, y1])
    return (out[:-1] if odd else out).reshape(count.shape)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the threefry hash of the counts ``(0,
    uint32(data))``. ``data`` is a host int or an int tensor broadcasting
    against ``key[..., 0]`` (a batch's per-trial ticks)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK32
    else:
        data = int(data) & MASK32
    y0, y1 = threefry2x32(key, 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, width: int, shape: tuple) -> torch.Tensor:
    """``jax.random.bits`` in the partitionable layout: the hash of each
    element's flat index (as two 32-bit words) under ``key``, then
    ``bits1 ^ bits2`` (width 32, values in [0, 2^32)) or ``bits1 << 32 |
    bits2`` (width 64, the bit pattern in an int64). The result has
    shape ``key.shape[:-1] + shape``."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    hi, lo = (idx >> 32).reshape(shape), (idx & MASK32).reshape(shape)
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    b1, b2 = threefry2x32(k, hi, lo)
    if width == 32:
        return b1 ^ b2
    if width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"random_bits supports widths 32 and 64, not {width}")


_FLOAT_BITS = {torch.float32: (32, 23, torch.int32),
               torch.float64: (64, 52, torch.int64)}


def rounded(value: float, dtype) -> float:
    """``value`` rounded to the float ``dtype`` (returned as a Python
    float): how a JAX constant enters an operation of that dtype."""
    return float(np.asarray(value, dtype=str(dtype).split(".")[-1]))


def uniform(key: torch.Tensor, shape: tuple, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: random mantissa bits under the exponent of
    1.0, minus 1, scaled to [minval, maxval) in ``dtype``, then
    ``max(minval, .)``. Bit for bit JAX's: XLA fuses the scaling into one
    multiply-add, taken here exactly in float64 for float32 draws; in
    float64 the scaling rounds twice, which is exact when the width
    ``maxval - minval`` is a power of two (every range the reference
    draws: [0, 1) and the normal's)."""
    nbits, nmant, itype = _FLOAT_BITS[dtype]
    bits = random_bits(key, nbits, shape)
    shift = nbits - nmant
    # a logical shift: the int64 shift is arithmetic, so mask the sign
    fbits = (bits >> shift) & ((1 << nmant) - 1)
    one = int(np.array(1.0, str(dtype).split(".")[-1]).view(
        np.int32 if nbits == 32 else np.int64))
    floats = (fbits | one).to(itype).view(dtype) - 1.0
    lo = torch.full((), rounded(minval, dtype), dtype=dtype,
                    device=key.device)
    hi = torch.full((), rounded(maxval, dtype), dtype=dtype,
                    device=key.device)
    if dtype == torch.float32:
        scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    else:
        scaled = floats * (hi - lo) + lo
    return torch.maximum(lo, scaled)


# XLA's erf_inv (the CHLO decomposition JAX lowers `lax.erf_inv` to):
# Giles, "Approximating the erfinv function" — the single-precision form,
# split at w = -log1p(-x^2) < 5, and the double-precision form, split at
# w < 6.25 and w < 16. Coefficients highest order first.
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


# fdlibm's log (`e_log.c`): the kernel polynomial and ln 2 in two parts
_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
       2.857142874366239149e-01, 2.222219843214978396e-01,
       1.818357216161805012e-01, 1.531383769920937332e-01,
       1.479819860511658591e-01)
_LN2_HI, _LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10
_SQRT2 = 1.4142135623730951
# XLA's log1p (`ElementalIrEmitter::EmitLog1p`): Cephes' rational form
# for |x| < sqrt(2) - 1, log(1 + x) elsewhere; highest order first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880


def _log(y: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal float64 values from +, -, *, /
    alone (fdlibm's algorithm, < 1 ulp). Not `torch.log`: on the CPU that
    takes a vectorized or a scalar path by an element's position in the
    tensor, so a batch of draws and the same draws alone could differ in
    the last bit; basic operations round the same everywhere, card and
    CPU alike."""
    bits = y.view(torch.int64)
    k = (bits >> 52) - 1023
    m = ((bits & ((1 << 52) - 1)) | (1023 << 52)).view(torch.float64)
    big = m > _SQRT2
    m = torch.where(big, m * 0.5, m)
    k = (k + big.to(torch.int64)).to(torch.float64)
    f = m - 1.0
    s = f / (2.0 + f)
    z = s * s
    w = z * z
    t1 = w * (_LG[1] + w * (_LG[3] + w * _LG[5]))
    t2 = z * (_LG[0] + w * (_LG[2] + w * (_LG[4] + w * _LG[6])))
    r = t2 + t1
    hfsq = 0.5 * f * f
    return k * _LN2_HI - ((hfsq - (s * (hfsq + r) + k * _LN2_LO)) - f)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log1p`` for x in (-1, 1), in x's dtype: the rational form
    as XLA evaluates it near 0, and elsewhere ``log(1 + x)`` through
    `_log` in float64 (XLA's own log is not reproduced)."""
    xx = x * x
    small = _horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)
    small = x + (-0.5 * xx + (x * xx) * small)
    large = _log((x + 1.0).double()).to(x.dtype)
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, large)


def _horner(coefs, w: torch.Tensor) -> torch.Tensor:
    """``c0 w^(k-1) + ... + c(k-1)`` as XLA evaluates it, ``p = c + p * w``
    from the highest order down with each coefficient rounded to ``w``'s
    dtype. XLA contracts each step to a fused multiply-add; in float32
    the fused step is taken exactly in float64 and rounded once (the
    product of two floats is exact there), in float64 it is two
    roundings."""
    if w.dtype == torch.float32:
        w64 = w.double()
        p = torch.full_like(w, rounded(coefs[0], w.dtype))
        for c in coefs[1:]:
            p = (p.double() * w64 + rounded(c, w.dtype)).float()
        return p
    p = torch.full_like(w, coefs[0])
    for c in coefs[1:]:
        p = p * w + c
    return p


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` for float32 and float64 (see the tables above);
    ``x = +-1`` gives ``+-inf``. XLA selects each coefficient per element;
    here each branch's polynomial runs on every element and the branch is
    selected once, which gives the same bits."""
    w = -_log1p(-x * x)
    if x.dtype == torch.float32:
        # the root in float64, rounded once to float32: the correctly
        # rounded float32 root, which the CPU's float32 `torch.sqrt`
        # gives and the card's does not (it differed in 19880 of 3*10^6
        # roots, `scripts/prng_bisect.py`)
        sw = torch.sqrt(w.double()).float()
        p = torch.where(w < 5.0, _horner(_ERFINV32_LT5, w - 2.5),
                        _horner(_ERFINV32_GE5, sw - 3.0))
    elif x.dtype == torch.float64:
        sw = torch.sqrt(w)
        p = torch.where(
            w < 6.25, _horner(_ERFINV64_LT625, w - 3.125),
            torch.where(w < 16.0, _horner(_ERFINV64_LT16, sw - 3.25),
                        _horner(_ERFINV64_GE16, sw - 5.0)))
    else:
        raise TypeError(f"erf_inv supports float32 and float64, not "
                        f"{x.dtype}")
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: tuple,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)``, ``u`` uniform on
    ``(nextafter(-1, 0), 1)`` in ``dtype``."""
    npd = str(dtype).split(".")[-1]
    lo = float(np.nextafter(np.array(-1.0, npd), np.array(0.0, npd)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return rounded(math.sqrt(2.0), dtype) * erf_inv(u)

"""The numerics of the fp32 SpMMs on the tensor cores (split TF32), on the CPU.

B1 / B3 (``csrc/bsr_spmm.cu``, ``csrc/bsr_spmm_t.cu``) multiply fp32
operands on the tensor cores, whose input is TF32 (10 mantissa bits). Each
operand is split as the kernels do (``split_tf32`` in ``csrc/common.cuh``):
``hi`` = x rounded to TF32 (to nearest, ties away from zero: what
``cvt.rna.tf32.f32`` returns), by ``(bits + 0x1000) & ~0x1fff``; ``lo`` =
x - hi in f32, which the tensor core reads as TF32 by dropping its low 13
bits. Three products hi.hi + hi.lo + lo.hi are summed in f32.

This file holds only the arithmetic argument behind that choice, with the
operands rounded here as the kernels and the tensor cores round them; the
kernels themselves are held on the card (``test_torch_kernels_cuda.py``).
The kernels' tolerance is 1e-4 * max|ref|.
"""

import numpy as np
import torch

TOL_KERNEL = 1e-4
MASK = -(1 << 13)            # 0xffffe000 as int32: TF32's 10 mantissa bits


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` by its definition: |x| to the nearest multiple
    of 2^(e - 10), e = floor(log2 |x|), ties away from zero (in float64,
    where every step below is exact for finite f32 x)."""
    x64 = x.double()
    a = x64.abs()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    e = torch.clamp(e, min=-126.0)          # subnormals share 2^-126's step
    ulp = torch.pow(2.0, e - 10)
    q = torch.floor(a / ulp + 0.5) * ulp    # a / ulp >= 0: floor(+0.5) is
    return torch.copysign(q, x64).float()   # round half away from zero


def _split(x: torch.Tensor):
    """The kernels' split: hi by integer rounding, lo = x - hi in f32."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & MASK).view(torch.float32)
    return hi, x - hi


def _tc_read(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 register given as TF32: its low
    13 bits dropped."""
    return (x.contiguous().view(torch.int32) & MASK).view(torch.float32)


def _f32(bits):
    return torch.tensor(np.asarray(bits, np.uint32).view(np.int32)).view(
        torch.float32)


def _values():
    """Normal f32 values over the whole exponent range with random
    mantissas, both signs, +-0, the smallest normal, and the largest
    values whose hi stays finite (0x7f7fefff: its low 13 bits round down;
    from 0x7f7ff000 up, hi rounds to inf, as cvt.rna's does)."""
    rng = np.random.RandomState(0)
    exps = rng.randint(1, 255, size=20000).astype(np.uint32)
    mant = rng.randint(0, 1 << 23, size=20000).astype(np.uint32)
    sign = rng.randint(0, 2, size=20000).astype(np.uint32)
    bits = (sign << 31) | (exps << 23) | mant
    edge = [0x00000000, 0x80000000, 0x00800000, 0x80800000, 0x00800fff,
            0x00801000, 0x7f7fefff, 0xff7fefff, 0x7f7fe000, 0x7f000fff,
            0x3f800000, 0x3f801000, 0x3f800fff, 0xbf801000, 0x3fffffff]
    return _f32(np.concatenate([bits, np.asarray(edge, np.uint32)]))


def test_split_hi_is_rna_and_hi_plus_lo_is_exact():
    x = _values()
    hi, lo = _split(x)
    # hi is cvt.rna.tf32.f32 of x (the definition, computed apart), a TF32
    # value, and finite up to 0x7f7fefff
    assert torch.equal(hi.view(torch.int32), _rna_tf32(x).view(torch.int32))
    assert torch.all(hi.view(torch.int32) & ~MASK == 0)
    assert torch.isfinite(hi).all()
    # x - hi is exact in f32: hi + lo gives x back, bit for bit where x is
    # not 0 (-0 comes back as +0: -0 - -0 is +0)
    back = hi + lo
    assert torch.all(back == x)
    nz = x != 0
    assert torch.equal(back[nz].view(torch.int32), x[nz].view(torch.int32))
    # hi keeps x's top 11 significant bits: |lo| <= 2^-11 |x|
    assert torch.all(lo.double().abs() <= x.double().abs() * 2.0 ** -11)
    # what the tensor core reads of lo is within 2^-21 |x| of lo, or, where
    # lo is subnormal (|x| below ~2^-115), within 2^-136: 13 dropped bits
    # of 2^-149
    err = (_tc_read(lo).double() - lo.double()).abs()
    assert torch.all(err <= torch.clamp(x.double().abs() * 2.0 ** -21,
                                        min=2.0 ** -136))
    # past 0x7f7fefff hi overflows: the kernels' range stops below it
    big, _ = _split(_f32([0x7f7ff000, 0xff7fffff]))
    assert torch.all(torch.isinf(big))


def _problem():
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(64, 4096).astype(np.float32))
    b = torch.from_numpy(rng.randn(4096, 64).astype(np.float32))
    ref = a.double() @ b.double()
    return a, b, ref, TOL_KERNEL * ref.abs().max().item()


def test_one_tf32_pass_misses_the_kernel_tolerance():
    """One TF32 rounding of each operand, products summed exactly (f64):
    the operand rounding alone puts the largest error above 1e-4 * max."""
    a, b, ref, limit = _problem()
    one = _rna_tf32(a).double() @ _rna_tf32(b).double()
    err = (one - ref).abs().max().item()
    assert err > limit, (err, limit)


def test_three_split_products_meet_it_with_a_10x_margin():
    """hi.hi + hi.lo + lo.hi as the tensor cores take them (lo read with
    its low bits dropped; every product of two TF32 values exact in f32),
    summed in f32: at least 10x inside 1e-4 * max."""
    a, b, ref, limit = _problem()
    ah, al = _split(a)
    bh, bl = _split(b)
    al, bl = _tc_read(al), _tc_read(bl)
    three = ah @ bh + ah @ bl + al @ bh
    err = (three.double() - ref).abs().max().item()
    assert err * 10 <= limit, (err, limit)


def _split_product(a, b):
    """a @ b in split TF32 as the tensor cores take it (lo read with its low
    bits dropped), the three products summed in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    al, bl = _tc_read(al), _tc_read(bl)
    return ah @ bh + ah @ bl + al @ bh


def test_flash_products_in_split_tf32_meet_1e5():
    """The flash forward's two products as its body splits them (B9 /
    B11a, ``csrc/flash_sparse_fwd.cu``): QK^T at hd = 128 (q, k split once
    a call) and PV over one 64-key tile (p split in registers, V's keys
    permuted inside each group of 8, which leaves the sum unchanged), each
    within 1e-5 * max of an f64 product."""
    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(64, 128).astype(np.float32) * 128 ** -0.5)
    k = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    sc = _split_product(q, k.T.contiguous())
    ref = q.double() @ k.double().T
    assert (sc.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
    p = torch.exp(sc - sc.amax(-1, keepdim=True))          # in [0, 1]
    v = torch.from_numpy(rng.randn(64, 128).astype(np.float32))
    perm = torch.tensor([8 * j + x for j in range(8)
                         for x in (0, 2, 4, 6, 1, 3, 5, 7)])
    pv = _split_product(p[:, perm], v[perm])
    ref = p.double() @ v.double()
    assert (pv.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


def _walk(prod, tiles=32, hd=64, seed=3):
    """One row walk of the flash backward's five products (B10a / B11b,
    ``csrc/flash_sparse_bwd.cu``) through ``prod``: per 64-key tile S = q
    K^T and dP = dO V^T, p = exp(S - m) / l from the f64 forward's m and l,
    ds = p (dP - D), then dQ += ds K (ds's keys permuted inside each group
    of 8, as the A fragments hold them), dK^T = q^T ds and dV^T = dO^T p.
    Returns (error, max|ref|) of dq, dk and dv against float64."""
    rng = np.random.RandomState(seed)

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    q, g = f(64, hd) * hd ** -0.5, f(64, hd)
    ks, vs = [f(64, hd) for _ in range(tiles)], [f(64, hd) for _ in range(
        tiles)]
    k64, v64 = torch.cat(ks).double(), torch.cat(vs).double()
    s64 = q.double() @ k64.T
    m64 = s64.amax(1)
    p64 = torch.exp(s64 - m64[:, None])
    l64 = p64.sum(1)
    p64 = p64 / l64[:, None]
    d64 = (g.double() * (p64 @ v64)).sum(1)
    ds64 = p64 * (g.double() @ v64.T - d64[:, None])
    ref = (ds64 @ k64, ds64.T @ q.double(), p64.T @ g.double())
    m, l, d = m64.float(), l64.float(), d64.float()
    perm = torch.tensor([8 * j + x for j in range(8)
                         for x in (0, 2, 4, 6, 1, 3, 5, 7)])
    dq, dks, dvs = torch.zeros(64, hd), [], []
    for k, v in zip(ks, vs):
        p = torch.exp(prod(q, k.T.contiguous()) - m[:, None]) / l[:, None]
        ds = p * (prod(g, v.T.contiguous()) - d[:, None])
        dq = dq + prod(ds[:, perm].contiguous(), k[perm])
        dks.append(prod(q.T.contiguous(), ds).T)
        dvs.append(prod(g.T.contiguous(), p).T)
    return [((a.double() - r).abs().max().item(), r.abs().max().item())
            for a, r in zip((dq, torch.cat(dks), torch.cat(dvs)), ref)]


def test_flash_backward_products_in_split_tf32_meet_1e4():
    """The row walk's five products in split TF32 over a 32-tile walk (the
    ring band's), the cancellation in ds = p (dP - D) included: dq, dk and
    dv within 1e-4 * max(1, max|ref|) of float64 with a 10x margin; one
    plain TF32 pass of the same products misses that limit on dq."""
    for err, mx in _walk(_split_product):
        assert err * 10 <= TOL_KERNEL * max(1.0, mx), (err, mx)

    def one_pass(a, b):
        return _rna_tf32(a) @ _rna_tf32(b)

    err, mx = _walk(one_pass)[0]
    assert err > TOL_KERNEL * max(1.0, mx), (err, mx)


def _column_walk(prod, tiles=32, hd=64, seed=4):
    """One column walk of the flash backward's four products (B10c,
    ``csrc/flash_sparse_bwd.cu``) through ``prod``, keys as M: per 64-row
    block S^T = K q^T and dP^T = V dO^T, p^T = exp(S^T - m) / l with m and
    l indexed by the column (the query row, from the f64 forward), ds^T =
    p^T (dP^T - D), then dK += ds^T q and dV += p^T dO with the score
    tiles' rows permuted inside each group of 8, as the A fragments hold
    them (the pre-pass stores q's and dO's transposes in that order).
    Returns (error, max|ref|) of dk and dv against float64."""
    rng = np.random.RandomState(seed)

    def f(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    k, v = f(64, hd), f(64, hd)
    qs = [f(64, hd) * hd ** -0.5 for _ in range(tiles)]
    gs = [f(64, hd) for _ in range(tiles)]
    # each row block's own softmax over these keys and 64 * 3 others
    others = [f(192, hd) for _ in range(tiles)]
    perm = torch.tensor([8 * j + x for j in range(8)
                         for x in (0, 2, 4, 6, 1, 3, 5, 7)])
    dk64 = torch.zeros(64, hd, dtype=torch.float64)
    dv64 = torch.zeros(64, hd, dtype=torch.float64)
    dk, dv = torch.zeros(64, hd), torch.zeros(64, hd)
    for q, g, ko in zip(qs, gs, others):
        keys = torch.cat([k, ko]).double()
        vals = torch.cat([v, f(192, hd)]).double()
        s64 = q.double() @ keys.T
        m64 = s64.amax(1)
        l64 = torch.exp(s64 - m64[:, None]).sum(1)
        p64 = torch.exp(s64 - m64[:, None])[:, :64] / l64[:, None]
        pall = torch.exp(s64 - m64[:, None]) / l64[:, None]
        d64 = (g.double() * (pall @ vals)).sum(1)
        ds64 = p64 * (g.double() @ v.double().T - d64[:, None])
        dk64 += ds64.T @ q.double()
        dv64 += p64.T @ g.double()
        m, l, d = m64.float(), l64.float(), d64.float()
        pt = torch.exp(prod(k, q.T.contiguous()) - m[None]) / l[None]
        dst = pt * (prod(v, g.T.contiguous()) - d[None])
        dk = dk + prod(dst[:, perm].contiguous(), q[perm])
        dv = dv + prod(pt[:, perm].contiguous(), g[perm])
    return [((a.double() - r).abs().max().item(), r.abs().max().item())
            for a, r in ((dk, dk64), (dv, dv64))]


def test_flash_column_walk_products_in_split_tf32_meet_1e4():
    """The column walk's four products in split TF32 over a 32-row-block
    walk (the ring band's column), the cancellation in ds = p (dP - D)
    included: dk and dv within 1e-4 * max(1, max|ref|) of float64 with a
    10x margin; one plain TF32 pass of the same products misses that limit
    on both."""
    for err, mx in _column_walk(_split_product):
        assert err * 10 <= TOL_KERNEL * max(1.0, mx), (err, mx)

    def one_pass(a, b):
        return _rna_tf32(a) @ _rna_tf32(b)

    for err, mx in _column_walk(one_pass):
        assert err > TOL_KERNEL * max(1.0, mx), (err, mx)

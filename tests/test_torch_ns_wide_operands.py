"""What the host prepares for the multi-pass Navier-Stokes step's products
(``pdecontrolgym_tpu_torch/csrc/ns_wide.cu``): the split B operands of the
four products, their shared-memory layout, and the orders of rows, columns
and terms in which the products hand their results on.

No card is needed. The chain of transposed products is run here in float64
with ``torch.matmul`` on the split operands, once as four matrix products and
once thread by thread as the kernel stores and loads its fragments, and held
to the plain step's pressure. The file imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.ops import ns_fused as tns
from pdecontrolgym_tpu_torch.ops.poisson2d import mirror_ring

LID_BC = (("Dirchilet", "Dirchilet"), ("Controllable", "Dirchilet"),
          ("Dirchilet", "Dirchilet"), ("Dirchilet", "Dirchilet"))
MIXED_BC = (("Neumann", "Dirchilet"), ("Controllable", "Neumann"),
            ("Dirchilet", "Controllable"), ("Neumann", "Neumann"))
# padded sides 192 and 256 (products 2 and 3 fused), 320 (tiles of 160), 384
# (192) and 512 (256)
GRIDS = [(136, 144), (160, 200), (256, 256), (300, 260), (384, 330), (512, 400)]


def _padded(ny, nx):
    return -(-max(ny, nx) // 64) * 64


def _bases(ny, nx):
    np_ = _padded(ny, nx)
    out = {}
    for k, a in tns.fused_basis_np(ny, nx).items():
        m = np.zeros((np_, np_), np.float32)
        m[:a.shape[0], :a.shape[1]] = a
        out[k] = m
    return out


def test_wide_tile_fuses_to_256_and_divides_above():
    assert [tns.wide_tile(n) for n in (192, 256)] == [192, 256]
    assert [tns.wide_tile(n) for n in range(320, 1025, 64)] == [
        160, 192, 224, 256, 192, 160, 176, 256, 208, 224, 192, 256]
    for n in range(320, 1025, 64):
        nt = tns.wide_tile(n)
        assert n % nt == 0 and 160 <= nt <= 256 and nt % 16 == 0


@pytest.mark.parametrize("np_", [192, 256, 320, 512])
def test_wide_maps_are_permutations_within_their_blocks(np_):
    maps = tns.wide_maps(np_, tns.wide_tile(np_))
    for name, m in maps.items():
        assert sorted(m.tolist()) == list(range(np_)), name
    nt = tns.wide_tile(np_)
    # a tile's columns stay in the tile; rows and terms in their 16 or 8
    assert (maps["col"] // nt == np.arange(np_) // nt).all()
    assert (maps["row1"] // 16 == np.arange(np_) // 16).all()
    assert (maps["k3"] // 8 == np.arange(np_) // 8).all()
    assert sorted(tns._bf16_order(np_).tolist()) == list(range(np_))


@pytest.mark.parametrize("ny,nx", GRIDS)
def test_highest_operands_split_the_float32_basis_exactly(ny, nx):
    """"highest": hi has its low 13 mantissa bits zero (a TF32 value) and
    hi + lo is the float32 basis bit for bit, each in the orientation and
    order the kernel reads: [output column][term]."""
    ops = tns.wide_operands(ny, nx, "highest")
    np_ = _padded(ny, nx)
    b = _bases(ny, nx)
    maps = tns.wide_maps(np_, ops["tile"])
    col = maps["col"]
    want = (b["qy"][:, col].T,                      # [c][y] = Qy[y][ky(c)]
            b["qx"].T,                              # [kx][x] = Qx[x][kx]
            b["qx"][col][:, maps["k3"]],            # [c][k] = Qx[x(c)][kx(k)]
            b["qy"][:, maps["k4"]])                 # [y][k] = Qy[y][ky(k)]
    for (hi, lo), w in zip(ops["products"], want):
        assert hi.dtype == lo.dtype == np.float32 and hi.shape == (np_, np_)
        assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
        np.testing.assert_array_equal((hi + lo).view(np.uint32),
                                      np.ascontiguousarray(w).view(np.uint32))
    np.testing.assert_array_equal(ops["inv"], b["inv"])


@pytest.mark.parametrize("precision", ["high", "default"])
def test_bf16_operands_are_the_head_and_tail_in_the_bf16_order(precision):
    ny, nx = 160, 200
    ops32 = tns.wide_operands(ny, nx, "highest")
    ops = tns.wide_operands(ny, nx, precision)
    order = tns._bf16_order(_padded(ny, nx))
    for (h32, l32), (hi, lo) in zip(ops32["products"], ops["products"]):
        x = torch.from_numpy((h32 + l32)[:, order])
        head = x.bfloat16().float()
        np.testing.assert_array_equal(hi, head.numpy())
        tail = (x - head).bfloat16().float() if precision == "high" else torch.zeros_like(x)
        np.testing.assert_array_equal(lo, tail.numpy())


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_block_operand_lays_slices_out_as_core_matrices(precision):
    """Byte for byte: tile, slice, half of the slice's terms, group of 8
    columns, column, 16 bytes of terms."""
    rng = np.random.default_rng(0)
    np_, nt = 320, 64
    x = rng.normal(size=(np_, np_)).astype(np.float32)
    if precision != "highest":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    got = tns.block_operand(x, nt, precision)
    per, ki, esize = (4, 8, 4) if precision == "highest" else (8, 16, 2)
    assert got.size == np_ * np_ * esize
    for n, k in ((0, 0), (5, 3), (70, 9), (319, 319), (130, 17), (64, 200)):
        tile, nl = divmod(n, nt)
        sl, kk = divmod(k, ki)
        off = ((((tile * (np_ // ki) + sl) * 2 + kk // per) * (nt // 8) + nl // 8) * 8
               + nl % 8) * per + kk % per
        raw = got[off * esize:(off + 1) * esize]
        if precision == "highest":
            assert raw.view(np.float32)[0] == x[n, k]
        else:
            value = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16).float()
            assert float(value[0]) == x[n, k]


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_kernel_constants_hold_the_blocked_operands_then_inv(precision):
    spec = tns.NSStepSpec(136, 144, 1 / 143, 1 / 135, 1e-5, 0.05, 1.0, LID_BC, precision)
    assert spec.wide and spec.padded == 192
    consts = spec.kernel_constants("cpu").numpy()
    ops = tns.wide_operands(136, 144, precision)
    esize = 4 if precision == "highest" else 2
    mat = 192 * 192 * esize
    assert consts.size == 8 * mat + 192 * 192 * 4
    for i, (hi, lo) in enumerate(ops["products"]):
        for j, m in enumerate((hi, lo)):
            np.testing.assert_array_equal(consts[(2 * i + j) * mat:(2 * i + j + 1) * mat],
                                          tns.block_operand(m, 192, precision))
    np.testing.assert_array_equal(consts[8 * mat:].view(np.float32).reshape(192, 192),
                                  ops["inv"])


def _plain_g_and_p(spec, seed):
    """The plain step's G (float32, padded) and its pressure output."""
    ny, nx = spec.ny, spec.nx
    rng = np.random.default_rng(seed)
    u, v = (torch.from_numpy(rng.uniform(-5, 5) + 0.2 * rng.normal(size=(2, ny, nx))
                             .astype(np.float32)) for _ in range(2))
    act = torch.tensor([[1.5], [-0.5]])
    chdx, chdy, cinv, dt, nu, cg, _ = spec.scalars()
    uc, vc = u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1]

    def predict(f):
        c, fxp, fxm, fyp, fym = (f[..., 1:-1, 1:-1], f[..., 1:-1, 2:], f[..., 1:-1, :-2],
                                 f[..., 2:, 1:-1], f[..., :-2, 1:-1])
        out = f.clone()
        out[..., 1:-1, 1:-1] = c + dt * (-uc * ((fxp - fxm) * chdx) - vc * ((fyp - fym) * chdy)
                                         + nu * ((fxm + fym - 4.0 * c + fxp + fyp) * cinv))
        return out

    up, vp = tns.apply_boundary(predict(u), predict(v), spec.boundary_condition,
                                act[:, :, None], act[:, :, None])
    g = torch.zeros((2, spec.padded, spec.padded))
    g[:, 1:ny - 1, 1:nx - 1] = cg * ((up[:, 1:-1, 2:] - up[:, 1:-1, :-2]) * chdx
                                     + (vp[:, 2:, 1:-1] - vp[:, :-2, 1:-1]) * chdy)
    return g.double(), tns.ns_step_plain(spec, u, v, act)[2]


def _chain(ops, g):
    """The four transposed products as matrix products, in the kernel's
    orders, float64 on hi + lo."""
    np_ = g.shape[-1]
    maps = tns.wide_maps(np_, ops["tile"])
    X = [torch.from_numpy(hi.astype(np.float64) + lo) for hi, lo in ops["products"]]
    inv = torch.from_numpy(ops["inv"]).double()
    col, row1 = torch.from_numpy(maps["col"]), torch.from_numpy(maps["row1"])
    d1 = g.transpose(-1, -2)[:, row1] @ X[0].T          # [r][c] = T1[ky(c)][x(r)]
    t1 = torch.zeros_like(g)
    t1[:, col.unsqueeze(1), row1.unsqueeze(0)] = d1.transpose(-1, -2)
    t = (t1 @ X[1].T) * inv                             # [ky][kx]
    d3 = t[:, :, torch.from_numpy(maps["k3"])] @ X[2].T  # [ky][c] = E[ky][x(c)]
    e = torch.zeros_like(g)
    e[:, :, col] = d3
    return (e.transpose(-1, -2)[:, :, torch.from_numpy(maps["k4"])] @ X[3].T).transpose(-1, -2)


@pytest.mark.parametrize("ny,nx,bc", [(136, 144, MIXED_BC), (256, 256, LID_BC),
                                      (300, 260, MIXED_BC)])
def test_transposed_chain_on_the_split_operands_is_the_plain_pressure(ny, nx, bc):
    """In float64 the chain equals the spectral solve on the float32 bases
    (to 1e-12 of its largest value) and the plain step's float32 pressure in
    the band of tests/test_torch_ns_wide_cuda.py (2e-5 of its largest value
    times np / 128)."""
    spec = tns.NSStepSpec(ny, nx, 1 / (nx - 1), 1 / (ny - 1), 1e-5, 0.05, 1.0, bc)
    g, p_plain = _plain_g_and_p(spec, seed=ny)
    ops = tns.wide_operands(ny, nx, "highest")
    got = _chain(ops, g)
    b = {k: torch.from_numpy(a).double() for k, a in _bases(ny, nx).items()}
    want = b["qy"] @ (((b["qyT"] @ g) @ b["qx"]) * b["inv"]) @ b["qxT"]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * scale
    p = mirror_ring(got[:, 1:ny - 1, 1:nx - 1]).float()
    np.testing.assert_allclose(p.numpy(), p_plain.numpy(), rtol=0,
                               atol=2e-5 * max(1.0, scale) * spec.padded / 128)


def _fo(mb, s, w, lane, np_):
    return (((mb * (np_ // 8) + s) * 4 + w) * 32 + lane) * 4


@pytest.mark.parametrize("ny,nx", [(136, 144), (300, 260)])
def test_fragment_order_stores_and_loads_compose_to_the_pressure(ny, nx):
    """The kernel's data flow thread by thread (float64, one env): each
    warpgroup's A fragments formed or loaded at the offsets the kernel uses,
    each product's accumulators stored as the kernel stores them (transposed
    into the next operand, in the same orientation, or as P [y][x])."""
    np_ = _padded(ny, nx)
    ops = tns.wide_operands(ny, nx, "highest")
    nt = ops["tile"]
    X = [hi.astype(np.float64) + lo for hi, lo in ops["products"]]
    inv = ops["inv"].astype(np.float64)
    rng = np.random.default_rng(1)
    G = np.zeros((np_, np_))
    G[1:ny - 1, 1:nx - 1] = rng.normal(size=(ny - 2, nx - 2))
    w, gq, t = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(8), np.arange(4),
                                               indexing="ij"))
    lane, r1 = 4 * gq + t, 16 * w + gq
    blocks = [(mb, n0) for mb in range(np_ // 64) for n0 in range(0, np_, nt)]

    def chunks(D, n0):  # a thread's four accumulators of each 8-column chunk
        for j in range(nt // 8):
            c1 = 8 * j + 2 * t
            yield j, (D[r1, c1], D[r1, c1 + 1], D[r1 + 8, c1], D[r1 + 8, c1 + 1])

    def load(src, mb):
        A = np.zeros((64, np_))
        for s in range(np_ // 8):
            i = _fo(mb, s, w, lane, np_)
            A[r1, 8 * s + t], A[r1 + 8, 8 * s + t] = src[i], src[i + 1]
            A[r1, 8 * s + t + 4], A[r1 + 8, 8 * s + t + 4] = src[i + 2], src[i + 3]
        return A

    def store_transposed(out, D, mb, n0):
        s = 8 * mb + 2 * w + (gq >> 2)
        for j, d in chunks(D, n0):
            m = n0 + 16 * (j >> 1) + 4 * (j & 1) + t
            i = _fo(m >> 6, s, (m >> 4) & 3, 4 * (m & 7) + (gq & 3), np_)
            for e in range(4):
                out[i + e] = d[e]

    s0, s1, P = np.zeros(np_ * np_), np.zeros(np_ * np_), np.zeros((np_, np_))
    for mb, n0 in blocks:  # product 1, G formed as the kernel forms it
        A = np.zeros((64, np_))
        x0 = 64 * mb + 16 * w + 8 * (gq >> 2) + (gq & 3)
        for s in range(np_ // 8):
            y0 = 8 * s + t
            A[r1, y0], A[r1 + 8, y0] = G[y0, x0], G[y0, x0 + 4]
            A[r1, y0 + 4], A[r1 + 8, y0 + 4] = G[y0 + 4, x0], G[y0 + 4, x0 + 4]
        store_transposed(s0, A @ X[0][n0:n0 + nt].T, mb, n0)
    for mb, n0 in blocks:  # product 2, * inv, in the same orientation
        D = (load(s0, mb) @ X[1][n0:n0 + nt].T) * inv[64 * mb:64 * mb + 64, n0:n0 + nt]
        for j, d in chunks(D, n0):
            i = _fo(mb, n0 // 8 + j, w, lane, np_)
            s1[i], s1[i + 1], s1[i + 2], s1[i + 3] = d[0], d[2], d[1], d[3]
    for mb, n0 in blocks:  # product 3
        store_transposed(s0, load(s1, mb) @ X[2][n0:n0 + nt].T, mb, n0)
    for mb, n0 in blocks:  # product 4, as P [y][x]
        x = 64 * mb + 16 * w + gq
        for j, d in chunks(load(s0, mb) @ X[3][n0:n0 + nt].T, n0):
            y = n0 + 8 * j + 2 * t
            P[y, x], P[y + 1, x], P[y, x + 8], P[y + 1, x + 8] = d
    b = _bases(ny, nx)
    want = b["qy"].astype(np.float64) @ (
        ((b["qyT"].astype(np.float64) @ G) @ b["qx"]) * b["inv"]) @ b["qxT"]
    np.testing.assert_allclose(P, want, rtol=0, atol=1e-12 * np.abs(want).max())

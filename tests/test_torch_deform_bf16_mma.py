"""The bf16 deformable conv's tensor-core kernels
(``aanet_torch/csrc/deform_conv.cu``: ``deform_fwd_mma_kernel``, the
forward, and ``deform_bwd_data_mma_kernel``, the input/offset/mask
gradient), on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain twins there). Here: the forward's exact split of a float32
sample into three bf16 planes (``ops.deform.split_planes``, the kernel's
``split_planes``) and the exactness of each plane's product with a bf16
weight; the plans at every path shape (a block's and an SM's shared
memory, every channel once, the resident blocks of the 128-channel
layer-3 convs); the plans' constants against the kernel source; and a numpy
replay of each kernel's contraction, lane by lane: the shared-memory
layouts and swizzles, ``ldmatrix`` and ``mma.sync.m16n8k16`` as PTX defines
their fragments, and the weight in fragment order
(``weight_fwd_fragments``, ``weight_bwd_fragments``), against the product
in float64.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from aanet_torch.ops import deform
from test_torch_deform_plan import PATH_SHAPES, UNET_SHAPES, _isa_convs

K, DIL, PAD, GROUPS = 3, 2, 2, 2  # every deformable conv of the port's models
SMS = 132
SOURCE = (pathlib.Path(deform.__file__).parents[1] / "csrc" / "deform_conv.cu").read_text()


def _seeded_floats(n, seed):
    """float32 values over the whole exponent range: random bit patterns
    (subnormals, both signs, inf and NaN among them), zeros and the
    extremes."""
    bits = np.random.RandomState(seed).randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    extra = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, np.finfo(np.float32).max,
                      -np.finfo(np.float32).max, np.finfo(np.float32).tiny, 2.0**-149, -2.0**-149,
                      2.0**-126 - 2.0**-149, 1.0, 1.0 + 2.0**-23], dtype=np.float32)
    return torch.from_numpy(np.concatenate([x, extra]))


def test_split_planes_is_exact():
    """hi + 2^-8 mid + 2^-16 lo == x exactly (in float64) for every finite
    float32, subnormals included; each plane is a bf16 value; inf and NaN
    pass through hi with mid and lo zero."""
    x = _seeded_floats(100_000, 0)
    hi, mid, lo = deform.split_planes(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    finite = torch.isfinite(x)
    sub = finite & (x != 0) & (x.abs() < 2.0**-126)
    assert int(sub.sum()) > 100  # subnormals are covered
    back = hi.double() + mid.double() * 2.0**-8 + lo.double() * 2.0**-16
    assert torch.equal(back[finite], x.double()[finite])
    nonfinite = ~finite
    assert int(nonfinite.sum()) > 100
    assert torch.equal(hi.float()[nonfinite].isnan(), x[nonfinite].isnan())
    assert torch.equal(hi.float()[nonfinite & ~x.isnan()], x[nonfinite & ~x.isnan()])
    assert not mid[nonfinite].float().any() and not lo[nonfinite].float().any()


def test_plane_products_are_exact():
    """A plane times a bf16 weight is exact in float32, and in float64 W.hi
    + 2^-8 W.mid + 2^-16 W.lo equals W.col: the kernel's three products,
    summed in float32, differ from W.col only in the order of the sum."""
    gen = torch.Generator().manual_seed(1)
    col = torch.randn(4096, generator=gen) * torch.exp2(torch.randint(-60, 60, (4096,), generator=gen))
    w = (torch.randn(4096, generator=gen) * torch.exp2(torch.randint(-20, 5, (4096,), generator=gen)))
    w = w.to(torch.bfloat16)
    planes = deform.split_planes(col)
    for plane in planes:
        exact = w.double() * plane.double()
        assert torch.equal((w.float() * plane.float()).double(), exact)
    total = sum(w.double() * p.double() * s for p, s in zip(planes, (1.0, 2.0**-8, 2.0**-16)))
    assert torch.equal(total, w.double() * col.double())


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def _out(size, stride):
    return (size + 2 * PAD - DIL * (K - 1) - 1) // stride + 1


PLAN_SHAPES = PATH_SHAPES + UNET_SHAPES


@pytest.mark.parametrize("x_shape,cout,stride", PLAN_SHAPES)
def test_bf16_plans_fit_and_cover(x_shape, cout, stride):
    """At every deformable conv of the presets' paths both plans fit a
    block's and, for their resident blocks, an SM's shared memory; the
    backward-data plan's chunks cover every channel of a group once and
    the forward's channel tile every output channel; the windows cover the
    taps at any offset within the halo."""
    b, cin, h, w = x_shape
    cg = cin // GROUPS
    data = deform.backward_data_plan_bf16(cin, cout, K, K, stride, PAD, DIL, GROUPS)
    assert data.chunk == deform.MMA_BD_CHUNK and data.chunks == -(-cg // data.chunk)
    assert data.chunk * (data.chunks - 1) < cg <= data.chunk * data.chunks
    assert data.blocks in deform.MMA_BD_BUILDS[data.tile_h]
    assert data.smem_bytes <= deform.SMEM_BYTES
    fit = deform.SM_SMEM_BYTES // (data.smem_bytes + 1024)
    assert data.blocks == max([b_ for b_ in deform.MMA_BD_BUILDS[data.tile_h] if b_ <= fit]
                              or [min(deform.MMA_BD_BUILDS[data.tile_h])])
    fwd = deform.forward_plan_bf16(b, cin, cout, _out(h, stride), _out(w, stride), K, K, stride, PAD,
                                   DIL, GROUPS, SMS)
    assert fwd.co_tile in deform.MMA_FWD_BUILDS and fwd.build == deform.MMA_FWD_BUILDS[fwd.co_tile]
    assert fwd.co_tile >= min(cout, 128) and (fwd.co_tile == 16 or fwd.co_tile // 2 < cout)
    assert fwd.smem_bytes <= deform.SMEM_BYTES
    assert 1 <= fwd.resident and fwd.resident * (fwd.smem_bytes + 1024) <= deform.SM_SMEM_BYTES
    chunks = GROUPS * -(-cg // deform.MMA_FWD_CHUNK)
    assert fwd.splits == 1 or (fwd.splits % GROUPS == 0 and chunks % fwd.splits == 0)
    from test_torch_deform_plan import _assert_window_covers
    _assert_window_covers(h, w, stride, data.tile_h, data.win_h, data.win_w)
    _assert_window_covers(h, w, stride, deform.MMA_FWD_TH, fwd.win_h, fwd.win_w)


@pytest.mark.parametrize("x_shape,cout,stride", [s for s in PATH_SHAPES if s[1] == 128])
def test_bf16_backward_data_keeps_its_resident_blocks(x_shape, cout, stride):
    """The 128-channel layer-3 convs: the tensor-core input/offset/mask
    gradient keeps at least the resident warps the kernel had before its
    fixed-point window took a second word (3 blocks of 8 warps at stride
    1, 1 at stride 2), and more than the bf16 form it replaces (which
    staged float32: 2 blocks at stride 1)."""
    before = {1: 24, 2: 8}[stride]
    cin = x_shape[1]
    plan = deform.backward_data_plan_bf16(cin, cout, K, K, stride, PAD, DIL, GROUPS)
    fit = deform.SM_SMEM_BYTES // (plan.smem_bytes + 1024)
    warps = min(plan.blocks, fit) * plan.tile_h
    assert warps >= before
    old = deform.backward_data_plan(cin, cout, K, K, stride, DIL, GROUPS)
    old_warps = min(old.blocks, deform.SM_SMEM_BYTES // (old.smem_bytes + 1024)) * 8
    assert warps >= old_warps and plan.smem_bytes < old.smem_bytes


@pytest.mark.parametrize("cout", range(1, 261))
def test_bf16_plans_take_every_output_channel_count(cout):
    """Every cout from 1 to 260 (cin 64 in two groups, the step's 96x192
    at batch 16): a forward plan whose tiles cover cout once, and a
    backward-data plan."""
    fwd = deform.forward_plan_bf16(16, 64, cout, 96, 192, K, K, 1, PAD, DIL, GROUPS, SMS)
    tiles = -(-cout // fwd.co_tile)
    assert (tiles - 1) * fwd.co_tile < cout <= tiles * fwd.co_tile
    assert fwd.blocks == -(-96 // deform.MMA_FWD_TH) * -(-192 // deform.TILE_W) * tiles * 16 * fwd.splits
    data = deform.backward_data_plan_bf16(64, cout, K, K, 1, PAD, DIL, GROUPS)
    assert data.smem_bytes <= deform.SMEM_BYTES


@pytest.mark.parametrize("name,max_disp", [("aanet", 48), ("aanet", 192), ("stereonet-aa", 48),
                                           ("stereonet-aa", 192)])
def test_bf16_plans_at_the_presets_convs(name, max_disp):
    """The presets' deformable convs (every output-channel count they have:
    the ISA convs' max_disp / scale / 2^i) plan in bf16 at the step's
    scales."""
    for cout, cin, stride, dil, groups in _isa_convs(name, max_disp):
        for h, w in ((96, 192), (24, 48)):
            deform.forward_plan_bf16(16, cin, cout, h // stride, w // stride, K, K, stride, PAD,
                                     dil, groups, SMS)
        plan = deform.backward_data_plan_bf16(cin, cout, K, K, stride, PAD, dil, groups)
        assert plan.chunk * plan.chunks >= cin // groups


@pytest.mark.parametrize("name", ["MMA_FWD_TH", "MMA_FWD_THREADS", "MMA_FWD_CHUNK", "MMA_BD_CHUNK",
                                  "TILE_W", "HALO"])
def test_bf16_constants_are_the_kernels(name):
    """The plans' constants are the kernels': tile rows, block and chunks;
    and the kernels are built for each channel tile, tile height and
    register budget the plans may name."""
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert found == [str(getattr(deform, name))]
    fwd_builds = set(re.findall(r"AANET_FWD_MMA\((\d+), (\d+)\)", SOURCE))
    assert {(str(c // 16), str(b)) for c, b in deform.MMA_FWD_BUILDS.items()} == fwd_builds
    bd_builds = set(re.findall(r"AANET_BWD_DATA_MMA\((\d+), (\d+)\)", SOURCE))
    assert bd_builds == {(str(th), str(b)) for th, bs in deform.MMA_BD_BUILDS.items() for b in bs}


@pytest.mark.parametrize("padding", [0, 1, 2, 5])
def test_bf16_shared_memory_is_the_kernels(padding):
    """The plans' shared-memory sizes are the kernels' layouts, evaluated
    from the source's own expressions (``raw_row``, ``raw_channel``,
    ``fixed_channel`` and the two ``*_smem_bytes``)."""
    def c_expr(fn):
        body = re.search(rf"inline (?:int|long long) {fn}\((.*?)\) \{{(.*?)\n\}}", SOURCE, re.S)
        return body.group(1), body.group(2)

    _, row = c_expr("raw_row")
    assert "(xoff + win_w + 7) / 8 * 8" in row
    _, chan = c_expr("raw_channel")
    assert "(win_h * win_wa + unit - 1) / unit" in chan and "if (n % 2 == 0) ++n;" in chan
    _, fixed = c_expr("fixed_channel")
    assert "while (n % 16 != 4) ++n;" in fixed
    _, fwd = c_expr("fwd_mma_smem_bytes")
    assert ("16LL * taps * MMA_FWD_TH * TILE_W + 2LL * 2 * MMA_FWD_CHUNK * xcs +\n"
            "         2LL * (MMA_FWD_THREADS / 32) * 3 * 8 * MMA_FWD_CHUNK") in fwd
    _, bwd = c_expr("bwd_data_mma_smem_bytes")
    assert "2LL * cout16 * tile_h * TILE_W + 2LL * MMA_BD_CHUNK * xcs + 8LL * MMA_BD_CHUNK * ws" in bwd
    for stride in (1, 2):
        win_w = (deform.TILE_W - 1) * stride + 2 * DIL + 2 * deform.HALO + 2
        for win_h in (15, 19, 26):
            xoff, win_wa, xcs = deform._raw_geometry(win_h, win_w, padding, 8)
            assert xoff == (-padding - deform.HALO) % 8 and win_wa % 8 == 0
            assert win_wa >= xoff + win_w and (xcs // 8) % 2 == 1 and xcs >= win_h * win_wa
            _, _, xcs16 = deform._raw_geometry(win_h, win_w, padding, 16)
            assert (xcs16 // 16) % 2 == 1 and xcs16 >= win_h * win_wa
            ws = deform._fixed_channel(win_h, win_w)
            assert ws % 16 == 4 and win_h * win_w <= ws < win_h * win_w + 16
            assert deform._bwd_data_mma_smem(40, 8, win_h, win_w, padding) == (
                2 * 48 * 128 + 2 * 8 * xcs + 8 * 8 * ws)
            assert deform._fwd_mma_smem(K, K, win_h, win_w, padding) == (
                16 * 9 * 64 + 2 * 2 * 16 * xcs16 + 2 * 8 * 3 * 8 * 16)


# ---------------------------------------------------------------------------
# The contractions, replayed lane by lane
# ---------------------------------------------------------------------------


def _ldmatrix(smem, addrs, count, trans=False):
    """``ldmatrix.m8n8.x{count}``: lanes 8 i .. 8 i + 7 give the element
    addresses of matrix i's rows (8 values each); lane T receives, of each
    matrix M, M[T // 4, 2 (T % 4) + (0, 1)] (with .trans, M[2 (T % 4) + (0,
    1), T // 4]). Returns [32 lanes][count][2]."""
    out = np.zeros((32, count, 2))
    lane = np.arange(32)
    for i in range(count):
        m = np.stack([smem[addrs[8 * i + r]: addrs[8 * i + r] + 8] for r in range(8)])
        for e in range(2):
            out[:, i, e] = m[2 * (lane % 4) + e, lane // 4] if trans else m[lane // 4, 2 * (lane % 4) + e]
    return out


def _mma(acc, a, b):
    """``mma.sync.m16n8k16`` as PTX lays out its fragments: a [32][4][2]
    (a0: A[g, 2t + (0, 1)], a1: A[g + 8, ..], a2: A[g, 2t + 8 + ..], a3:
    A[g + 8, 2t + 8 + ..]), b [32][2][2] (b0: B[2t + (0, 1), g], b1: B[2t
    + 8 + .., g]), acc [32][4] (c0, c1: C[g, 2t + (0, 1)], c2, c3: C[g + 8,
    ..]); g = lane // 4, t = lane % 4."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        for e in range(2):
            A[g, 2 * t + e], A[g + 8, 2 * t + e] = a[lane, 0, e], a[lane, 1, e]
            A[g, 2 * t + 8 + e], A[g + 8, 2 * t + 8 + e] = a[lane, 2, e], a[lane, 3, e]
            B[2 * t + e, g], B[2 * t + 8 + e, g] = b[lane, 0, e], b[lane, 1, e]
    D = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc[lane] += (D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1])


def _bf16_values(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("cin,cout,groups", [(20, 24, 2), (32, 16, 1), (16, 40, 2)])
def test_forward_contraction_replay(cin, cout, groups):
    """``deform_fwd_mma_kernel``'s products for one tile: each warp's lanes
    store the three planes of their samples (pixel lane & 7, channels cq +
    4 i of the chunk at positions 4 cq + i, 16-byte halves swizzled by the
    pixel), read them back with ldmatrix as B, read A from the weight's
    fragments and accumulate one float32 sum a plane; the epilogue's hi +
    2^-8 (mid + 2^-8 lo) equals W . col (float64 sums)."""
    gen = torch.Generator().manual_seed(cin + cout)
    taps, cg = K * K, cin // groups
    P, CC = deform.MMA_FWD_TH * deform.TILE_W, deform.MMA_FWD_CHUNK
    weight = _bf16_values(gen, cout, cin, K, K)
    col = torch.randn(cin, taps, P, generator=gen) * torch.exp2(
        torch.randint(-8, 8, (cin, taps, P), generator=gen).float())
    plan = deform.forward_plan_bf16(1, cin, cout, 4, 16, K, K, 1, PAD, DIL, groups, SMS)
    mt = plan.co_tile // 16
    cout_pad = -(-cout // plan.co_tile) * plan.co_tile
    wf = deform.weight_fwd_fragments(weight, groups, cout_pad).float().numpy().reshape(-1, 32, 4, 2)
    planes = [p.float().numpy() for p in deform.split_planes(col)]
    per_group = -(-cg // CC)
    out = np.zeros((cout_pad, P))
    lane = np.arange(32)
    for warp in range(deform.MMA_FWD_THREADS // 32):
        pixels = (warp >> 1) * deform.TILE_W + (warp & 1) * 8 + np.arange(8)
        for tile in range(cout_pad // plan.co_tile):
            acc = np.zeros((mt, 3, 32, 4))
            for q in range(groups * per_group):
                c0 = (q // per_group) * cg + (q % per_group) * CC
                nc = min(CC, (q // per_group + 1) * cg - c0)
                for k in range(taps):
                    colw = np.zeros(3 * 8 * CC)
                    sj, cq = lane & 7, lane >> 3
                    for i in range(4):
                        c = cq + 4 * i
                        pos = sj * CC + 8 * ((cq >> 1) ^ ((sj >> 2) & 1)) + 4 * (cq & 1) + i
                        for pl in range(3):
                            v = np.where(c < nc, planes[pl][np.minimum(c0 + c, cin - 1), k, pixels[sj]], 0)
                            colw[pl * 8 * CC + pos] = v
                    lr, lh = lane & 7, (lane >> 3) & 1
                    swz = 8 * (lh ^ ((lr >> 2) & 1))
                    b01 = _ldmatrix(colw, (lane >> 4) * 8 * CC + lr * CC + swz, 4)
                    b2 = _ldmatrix(colw, 2 * 8 * CC + lr * CC + swz, 2)
                    bfr = [b01[:, 0:2], b01[:, 2:4], b2]
                    for i in range(mt):
                        a = wf[(q * taps + k) * (cout_pad // 16) + tile * mt + i]
                        for pl in range(3):
                            _mma(acc[i, pl], a, bfr[pl])
            g8, t4 = lane >> 2, lane & 3
            for i in range(mt):
                for rr in range(2):
                    for e in range(2):
                        c = 2 * rr + e
                        v = (acc[i, 2, :, c] * 2.0**-8 + acc[i, 1, :, c]) * 2.0**-8 + acc[i, 0, :, c]
                        out[tile * plan.co_tile + 16 * i + g8 + 8 * rr, pixels[2 * t4 + e]] = v
    want = np.einsum("ock,ckp->op", weight.double().numpy().reshape(cout, cin, taps),
                     col.double().numpy())
    np.testing.assert_allclose(out[:cout], want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    assert not out[cout:].any()


@pytest.mark.parametrize("cin,cout,groups,tile_h", [(16, 24, 2, 8), (20, 40, 2, 4), (8, 16, 1, 8)])
def test_backward_data_contraction_replay(cin, cout, groups, tile_h):
    """``deform_bwd_data_mma_kernel``'s column gradient for one tile: the
    gout tile staged in 16-byte pieces swizzled by the output channel,
    read as A with ldmatrix.trans (rows of 16 pixels, one a warp), B from
    the weight's fragments; lane (g, t) holds pixels g and g + 8 of its
    row by channels 2 t, 2 t + 1 of the chunk, equal to W^T . gout."""
    gen = torch.Generator().manual_seed(cin * cout)
    taps, cg = K * K, cin // groups
    P, CC = tile_h * deform.TILE_W, deform.MMA_BD_CHUNK
    weight = _bf16_values(gen, cout, cin, K, K)
    gout = _bf16_values(gen, cout, P)
    cout16 = -(-cout // 16) * 16
    chunks = -(-cg // CC)
    wf = deform.weight_bwd_fragments(weight, groups).float().numpy().reshape(-1, 32, 2, 2)
    assert wf.shape[0] == taps * groups * chunks * (cout16 // 16)
    smem = np.zeros(cout16 * P)
    g32 = gout.float().numpy()
    for co in range(cout16):
        for piece in range(2 * tile_h):
            if co < cout:
                smem[co * P + 8 * (piece ^ (co & 7)): co * P + 8 * (piece ^ (co & 7)) + 8] = \
                    g32[co, 8 * piece: 8 * piece + 8]
    lane = np.arange(32)
    gcol = np.full((cin, taps, P), np.nan)
    for g in range(groups):
        for chunk in range(chunks):
            c0 = g * cg + chunk * CC
            for warp in range(tile_h):
                piece = 2 * warp + ((lane >> 3) & 1)
                arow = ((lane & 7) + 8 * (lane >> 4)) * P + 8 * (piece ^ (lane & 7))
                for k in range(taps):
                    acc = np.zeros((32, 4))
                    for kk in range(cout16 // 16):
                        a = _ldmatrix(smem, arow + 16 * kk * P, 4, trans=True)
                        b = wf[((k * groups + g) * chunks + chunk) * (cout16 // 16) + kk]
                        _mma(acc, a, b)
                    for i in range(2):
                        for e in range(2):
                            c = 2 * (lane & 3) + e
                            ok = c < min(CC, (g + 1) * cg - c0)
                            px = 16 * warp + (lane >> 2) + 8 * i
                            gcol[c0 + c[ok], k, px[ok]] = acc[ok, 2 * i + e]
    want = np.einsum("ock,op->ckp", weight.double().numpy().reshape(cout, cin, taps),
                     g32.astype(np.float64))
    np.testing.assert_allclose(gcol, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())

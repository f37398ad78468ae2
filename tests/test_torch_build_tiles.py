"""The decompositions and numerics of the redesigned K2 (csrc/corr_build.cu)
and K1 (csrc/ba_blocks.cu), emulated in plain torch and numpy on the CPU; no
kernel runs here.

- K2's tiles: the cell grid is cut into aligned blocks of 8 level-0 rows x
  32 columns (the kernel's kRows x kCols).  Each block, zero-filled past the
  map as TMA fills it, pools alone to its cells of levels 1-3; the valid
  cells of all blocks put together equal corr_build_plain's four levels bit
  for bit, at full, ragged and small sizes.
- K2's 3xTF32: the product taken 8 channels a step as small*big +
  big*small + big*big, with big = x cut to TF32 (low 13 bits cleared) and
  small = x - big, stays within chip_smoke's K2 tolerance,
  1e-5 * max(1, |level0|), of the plain levels; one TF32 product does not.
- K2 with bf16 levels (corr_build_bf16_kernel): its epilogue's store map,
  with the accumulators laid out as wgmma leaves them, the quad transpose of
  level 0 and the shuffles that gather a pixel row of levels 2 and 3 into
  one lane, writes every cell of every level exactly once, in stores aligned
  to their width, and gives corr_build_plain's bf16 levels bit for bit.  Its
  persistent schedule takes every tile once, block b tiles b, b + G, ..., and
  its ring loads no stage before the products of the item in it are done,
  with the next tile's chunks in flight during each epilogue.
- K1's relative pose: the kernel's arithmetic (each operation rounded
  alone, in the plain version's order), emulated in numpy float32, gives
  edge_inputs' Gij, stereo self-edges included.
- K1's sums: Ji = L Jj with L = -AdjT(Gij) fixed per edge, so the kernel
  sums only Hjj (21 entries) and vj (6) and forms Hii = L Hjj L^T,
  Hij = L Hjj and vi = L vj once.  Its cluster split (an edge's pixels cut
  into 2 contiguous spans, one per block, each thread's pixels summed in
  order, the threads by an xor butterfly within each warp, the warps in
  order, then the blocks in rank order), followed by L, stays within K1's
  tolerance, 2e-4 * max(1, |ref|), of the JAX package's
  build_system_blocks, stereo self-edges included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.ba.system import build_system_blocks as j_build_system_blocks
from droid_slam_reserch_tpu_torch.geom import projective_transform
from droid_slam_reserch_tpu_torch.ops.corr import corr_volume_flat, pool2x_volume_flat
from droid_slam_reserch_tpu_torch.ops.cuda_ba import edge_inputs
from droid_slam_reserch_tpu_torch.ops.cuda_corr import corr_build_plain

torch.set_num_threads(1)
ROWS, COLS = 8, 32          # K2's tile of level-0 cells, the kernel's kRows x kCols
K2_TOL = 1e-5               # chip_smoke's K2 tolerance, times max(1, |level0|)
CLUSTER, THREADS = 2, 256   # K1's blocks per edge and threads per block
K1_TOL = 2e-4               # chip_smoke's K1 tolerance, times max(1, |ref|)
KEYS = ("Hii", "Hij", "Hji", "Hjj", "vi", "vj")


def _features(E, H, W, C, seed):
    rng = np.random.RandomState(seed)
    f1 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    return torch.from_numpy(f1), torch.from_numpy(f2)


def tile_build(f1, f2):
    """K2's algorithm tile by tile -> the four levels, and how often each
    cell of each level was written."""
    E, H1, W1, _ = f1.shape
    H, W = f2.shape[1:3]
    P = H1 * W1
    vol = corr_volume_flat(f1, f2)
    sizes = [(H >> l, W >> l) for l in range(4)]
    levels = [torch.full((E, P, h, w), float("nan")) for h, w in sizes]
    writes = [torch.zeros((E, P, h, w), dtype=torch.int32) for h, w in sizes]
    for y0 in range(0, H, ROWS):
        for x0 in range(0, W, COLS):
            tile = torch.zeros(E, P, ROWS, COLS)          # zeros past the map
            blk = vol[:, :, y0:y0 + ROWS, x0:x0 + COLS]
            tile[:, :, :blk.shape[2], :blk.shape[3]] = blk
            for l, (h, w) in enumerate(sizes):
                if l:
                    tile = pool2x_volume_flat(tile)        # this tile's cells of level l
                yl, xl = y0 >> l, x0 >> l
                nr, nc = max(0, min(tile.shape[2], h - yl)), max(0, min(tile.shape[3], w - xl))
                levels[l][:, :, yl:yl + nr, xl:xl + nc] = tile[:, :, :nr, :nc]
                writes[l][:, :, yl:yl + nr, xl:xl + nc] += 1
    return levels, writes


TILE_SHAPES = [(2, 40, 64), (2, 30, 44), (1, 48, 120), (2, 13, 20), (2, 5, 7)]
TILE_IDS = ["40x64", "30x44-ragged", "48x120-wide", "13x20-ragged", "5x7-small"]


@pytest.mark.parametrize("E,H,W", TILE_SHAPES, ids=TILE_IDS)
def test_k2_tiles_equal_the_plain_levels_bit_for_bit(E, H, W):
    f1, f2 = _features(E, H, W, 8, 0)
    levels, writes = tile_build(f1, f2)
    plain = corr_build_plain(f1, f2)
    for l, (mine, ref, n) in enumerate(zip(levels, plain, writes)):
        assert mine.shape == ref.shape, l
        assert bool((n == 1).all()), f"a cell of level {l} is written other than once"
        assert torch.equal(mine, ref), l


def tf32_cut(x):
    """x with its low 13 mantissa bits cleared: the kernel's big part, and
    the lower bound on what the tensor cores keep of any operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def levels_tf32(f1, f2, passes):
    """The four levels from TF32 products, 8 channels a step as wgmma k8
    takes them: passes=3 is 3xTF32 (small*big + big*small + big*big into one
    fp32 sum), passes=1 one TF32 product."""
    E, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    a, b = f1.reshape(E, H1 * W1, C), f2.reshape(E, H2 * W2, C)
    acc = torch.zeros(E, H1 * W1, H2 * W2)
    for k0 in range(0, C, 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8]
        ab, bb = tf32_cut(ak), tf32_cut(bk)
        if passes == 3:
            acc += torch.bmm(tf32_cut(ak - ab), bb.transpose(1, 2))
            acc += torch.bmm(ab, tf32_cut(bk - bb).transpose(1, 2))
        acc += torch.bmm(ab, bb.transpose(1, 2))
    lv = [(acc * 0.0625).reshape(E, H1 * W1, H2, W2)]
    for _ in range(3):
        lv.append(pool2x_volume_flat(lv[-1]))
    return lv


def test_k2_3xtf32_holds_the_tolerance_and_one_pass_does_not():
    f1, f2 = _features(2, 40, 64, 128, 1)
    plain = corr_build_plain(f1, f2)
    tol = K2_TOL * max(1.0, float(plain[0].abs().max()))
    errs = {}
    for passes in (3, 1):
        lv = levels_tf32(f1, f2, passes)
        errs[passes] = max(float((a - b).abs().max()) for a, b in zip(lv, plain))
    assert errs[3] <= tol, f"3xTF32 {errs[3]:.3e} > tol {tol:.3e}"
    assert errs[1] > tol, f"one TF32 product {errs[1]:.3e} already within tol {tol:.3e}"


def _poses(MW, seed):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([0.3 * rng.standard_normal((MW, 3)), 0.2 * rng.standard_normal((MW, 3))], 1)
    return np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))


def kernel_gij(poses, ii, jj):
    """csrc/ba_blocks.cu relative_pose in numpy float32, one operation at a
    time -> [N, 12] (row-major R, then t)."""
    f = np.float32
    P = poses.astype(f)

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]

    def quat_act(q, X):
        uv = [f(2.0) * c for c in cross(q, X)]
        c = cross(q, uv)
        return [(X[k] + q[3] * uv[k]) + c[k] for k in range(3)]

    Pi, Pj = P[ii].T, P[jj].T                        # [7, N] rows
    qi = [-Pi[3], -Pi[4], -Pi[5], Pi[6]]
    ti = [-v for v in quat_act(qi, Pi[:3])]
    qj = [Pj[3], Pj[4], Pj[5], Pj[6]]
    a = quat_act(qj, ti)
    t = [Pj[k] + a[k] for k in range(3)]
    qx, qy, qz, qw = qj
    px, py, pz, pw = qi
    q = [((qw * px + qx * pw) + qy * pz) - qz * py,
         ((qw * py + qy * pw) + qz * px) - qx * pz,
         ((qw * pz + qz * pw) + qx * py) - qy * px,
         ((qw * pw - qx * px) - qy * py) - qz * pz]
    self_edge = ii == jj                              # STEREO_SE3
    t = [np.where(self_edge, f(v), tk) for v, tk in zip((-0.1, 0.0, 0.0), t)]
    q = [np.where(self_edge, f(v), qk) for v, qk in zip((0.0, 0.0, 0.0, 1.0), q)]
    x, y, z, w = q
    xx, yy, zz, xy, xz, yz, wx, wy, wz = x * x, y * y, z * z, x * y, x * z, y * z, w * x, w * y, w * z
    two, one = f(2.0), f(1.0)
    R = [one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
         two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
         two * (xz - wy), two * (yz + wx), one - two * (xx + yy)]
    return np.stack(R + t, 1).astype(f)


def test_k1_kernel_gij_equals_edge_inputs():
    MW = 12
    poses = _poses(MW, 0)
    rng = np.random.RandomState(1)
    ii = rng.randint(0, MW, 40)
    jj = (ii + rng.randint(1, 5, 40)) % MW
    ii[:6] = jj[:6] = np.arange(6)                    # stereo self-edges
    ii[-2:] = jj[-2:] = 0                             # the engine's padding edges
    ref = edge_inputs(torch.from_numpy(poses), torch.from_numpy(ii), torch.from_numpy(jj)).numpy()
    mine = kernel_gij(poses, ii, jj)
    # 1-2 ulps: the CPU's torch kernels contract some of the products into fma
    np.testing.assert_allclose(mine, ref, rtol=0, atol=2e-7)
    assert np.array_equal(mine[:6, :9], np.eye(3, dtype=np.float32).reshape(1, 9).repeat(6, 0))


def _butterfly(x):
    """Lane 0 of an xor butterfly over the lanes axis (-2) of [..., 32, k]."""
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o, :] + x[..., o:2 * o, :]
    return x[..., 0, :]


def cluster_sums(terms):
    """[N, HW, k] per-pixel terms -> [N, k] summed in K1's order."""
    N, HW, k = terms.shape
    span = -(-(-(-HW // CLUSTER)) // 32) * 32
    parts = []
    for r in range(CLUSTER):
        lo, hi = min(r * span, HW), min((r + 1) * span, HW)
        steps = -(-(hi - lo) // THREADS)
        t = torch.zeros(N, steps * THREADS, k)
        t[:, :hi - lo] = terms[:, lo:hi]
        t = t.reshape(N, steps, THREADS, k)
        acc = torch.zeros(N, THREADS, k)
        for s in range(steps):                       # each thread's pixels in order
            acc = acc + t[:, s]
        red = _butterfly(acc.reshape(N, THREADS // 32, 32, k))
        part = red[:, 0]
        for w in range(1, THREADS // 32):            # the warps in order
            part = part + red[:, w]
        parts.append(part)
    out = parts[0]
    for p in parts[1:]:                              # the blocks in rank order
        out = out + p
    return out


def adj_t_matrix(R, t):
    """L = -AdjT(Gij) as a [N, 6, 6] matrix: column c is L e_c, with
    L a = [-R^T a_l; -R^T (a_a + a_l x t)] as the kernel's adj_t forms it."""
    N = R.shape[0]
    L = torch.zeros(N, 6, 6)
    Rt = R.transpose(1, 2)
    for c in range(6):
        a = torch.zeros(N, 6)
        a[:, c] = 1.0
        al = a[:, :3]
        aa = a[:, 3:] + torch.linalg.cross(al, t, dim=-1)
        L[:, :3, c] = -(Rt @ al[..., None])[..., 0]
        L[:, 3:, c] = -(Rt @ aa[..., None])[..., 0]
    return L


@pytest.mark.parametrize("H,W", [(40, 64), (13, 20)], ids=["40x64", "13x20-ragged"])
def test_k1_cluster_split_sums_hold_jax_blocks(H, W):
    MW, N = 6, 10
    rng = np.random.RandomState(2)
    xi = np.concatenate([0.1 * np.arange(MW)[:, None] * np.array([[1.0, 0.2, 0.1]]),
                         0.01 * rng.standard_normal((MW, 3))], 1)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.8 + 0.4 * rng.rand(MW, H, W)).astype(np.float32)
    intr = np.array([W / 1.5, W / 1.4, W / 2.0, H / 2.0], np.float32)
    ii = np.array([0, 1, 2, 3, 4, 1, 2, 3, 2, 5], np.int64)
    jj = np.array([1, 2, 3, 4, 5, 0, 1, 2, 2, 5], np.int64)     # two stereo self-edges
    target = (0.5 + rng.rand(N, H, W, 2) * np.array([W - 1.0, H - 1.0])).astype(np.float32)
    weight = rng.rand(N, H, W, 2).astype(np.float32)

    # per-pixel terms from the plain version's Jacobians: Hjj's 21 unique
    # entries and vj, as the kernel accumulates them
    t = {k: torch.from_numpy(v) for k, v in dict(poses=poses, disps=disps, intr=intr,
                                                 target=target, weight=weight).items()}
    ti, tj = torch.from_numpy(ii), torch.from_numpy(jj)
    coords, valid, (_, Jj, _) = projective_transform(
        t["poses"][None], t["disps"][None], t["intr"].expand(MW, 4)[None], ti, tj,
        jacobian=True, min_depth=0.25)
    r = (t["target"] - coords[0]).reshape(N, H * W, 2)
    w = (0.001 * valid[0] * t["weight"]).reshape(N, H * W, 2)
    wp = w * (ti != tj).float()[:, None, None]
    J = Jj[0].reshape(N, H * W, 2, 6)
    a_idx, b_idx = np.triu_indices(6)
    hterms = ((J[..., 0, a_idx] * wp[..., 0:1]) * J[..., 0, b_idx]
              + (J[..., 1, a_idx] * wp[..., 1:2]) * J[..., 1, b_idx])
    vterms = (wp[..., 0:1] * r[..., 0:1]) * J[..., 0, :] + (wp[..., 1:2] * r[..., 1:2]) * J[..., 1, :]
    sums = cluster_sums(torch.cat([hterms, vterms], -1))
    Hjj = torch.zeros(N, 6, 6)
    Hjj[:, a_idx, b_idx] = sums[:, :21]
    Hjj[:, b_idx, a_idx] = sums[:, :21]
    vj = sums[:, 21:]
    gij = edge_inputs(t["poses"], ti, tj)
    L = adj_t_matrix(gij[:, :9].reshape(N, 3, 3), gij[:, 9:])
    Hij = L @ Hjj
    mine = {"Hii": Hij @ L.transpose(1, 2), "Hij": Hij, "Hji": Hij.transpose(1, 2),
            "Hjj": Hjj, "vi": (L @ vj[..., None])[..., 0], "vj": vj}

    ref = j_build_system_blocks(
        jnp.asarray(target)[None], jnp.asarray(weight)[None], jnp.asarray(poses)[None],
        jnp.asarray(disps)[None], jnp.broadcast_to(jnp.asarray(intr), (1, MW, 4)),
        jnp.asarray(ii), jnp.asarray(jj), min_depth=0.25)
    for k in KEYS:
        a = np.asarray(ref[k][0])
        assert np.abs(a).max() > 0, k
        np.testing.assert_allclose(mine[k].numpy(), a, rtol=0,
                                   atol=K1_TOL * max(1.0, np.abs(a).max()), err_msg=k)


# ---- the bf16 kernel (corr_build_bf16_kernel): its epilogue's store map and
# its persistent schedule.  The kernel's constants: tiles of KM pixels x 8 x 32
# cells, 8 warps of 32 lanes, SMS blocks at most (the H100's SMs).
KM, WARPS, SMS = 128, 8, 132


def _bits(x):
    """bf16 bits of x (rounded to nearest even) as int64."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF


def _pack(a, b):
    """Io<bf16>::pack: a in the low half, b in the high half."""
    return _bits(a) | (_bits(b) << 16)


def _halves(w):
    return [w & 0xFFFF, (w >> 16) & 0xFFFF]


def _shfl_xor(x, m):
    """__shfl_xor_sync over the 32 lanes on the last dim of x."""
    return x[..., torch.arange(32) ^ m]


def _quad_transpose(x):
    """quad_transpose: x [..., 32 lanes, 4 words] -> word k of lane q is
    word q of lane k, within each quad, in the kernel's two xor steps."""
    x = x.clone()
    q = torch.arange(32) & 3
    b0, b1 = (q & 1).bool(), (q & 2).bool()
    for i in range(2):
        t = _shfl_xor(torch.where(b0, x[..., 2 * i], x[..., 2 * i + 1]), 1)
        x[..., 2 * i] = torch.where(b0, t, x[..., 2 * i])
        x[..., 2 * i + 1] = torch.where(b0, x[..., 2 * i + 1], t)
    for i in range(2):
        t = _shfl_xor(torch.where(b1, x[..., i], x[..., i + 2]), 2)
        x[..., i] = torch.where(b1, t, x[..., i])
        x[..., i + 2] = torch.where(b1, x[..., i + 2], t)
    return x


class _Memory:
    """The four bf16 levels as flat bf16 bits, with a write count a cell, and
    every store's width and byte address checked for alignment."""

    def __init__(self, E, P, H, W):
        self.sizes = [(H >> l, W >> l) for l in range(4)]
        self.P = P
        self.bits = [torch.zeros(E * P * h * w, dtype=torch.int64) for h, w in self.sizes]
        self.count = [torch.zeros(E * P * h * w, dtype=torch.int64) for h, w in self.sizes]

    def store(self, l, mask, e, p, y, x, cells):
        """Store run `cells` (a list of bit tensors, consecutive columns from
        x) where mask holds, as one store of len(cells) * 2 bytes."""
        h, w = self.sizes[l]
        off = ((e * self.P + p) * h + y) * w + x
        m = mask.reshape(-1)
        off = off.expand(mask.shape).reshape(-1)[m]
        width = 2 * len(cells)
        assert bool(((2 * off) % width == 0).all()), f"a {width}-byte store of level {l} misaligned"
        for k, c in enumerate(cells):
            assert bool((x.expand(mask.shape).reshape(-1)[m] + k < w).all()), "a store past a row"
            self.bits[l][off + k] = c.expand(mask.shape).reshape(-1)[m]
            self.count[l].index_add_(0, off + k, torch.ones_like(off))


def bf16_tile_path(f1, f2, chunk=256):
    """corr_build_bf16_kernel's epilogue with bf16 levels, emulated over the
    tiles of tile_at(), `chunk` tiles at a time: the accumulators as wgmma
    leaves them, each value rounded once after the scale, the quad transpose
    and the packing shuffles, and every store of every (tile, warp, lane)
    -> _Memory.  Tensors are [tile, warp, lane] or broadcast to it."""
    E, H1, W1, _ = f1.shape
    H, W = f2.shape[1:3]
    P = H1 * W1
    mem = _Memory(E, P, H, W)
    (H0, W0), (Hl1, Wl1), (Hl2, Wl2), (Hl3, Wl3) = mem.sizes
    ncols, nbands, nm = -(-W // COLS), -(-H // ROWS), -(-P // KM)
    nblk = ncols * nbands
    vol = torch.zeros(E, nm * KM, nbands * ROWS, ncols * COLS)   # TMA's zeros past the map
    vol[:, :P, :H, :W] = corr_volume_flat(f1, f2)      # scaled by 1/16, as acc * 0.0625
    lane = torch.arange(32)
    g, q = lane >> 2, lane & 3
    warp = torch.arange(WARPS)[:, None]
    i = torch.arange(128)
    j, hf_i, c_i = i >> 2, (i >> 1) & 1, i & 1
    # acc[..., warp, lane, i]: pixel (in the tile), row and column of the cell
    pix = 64 * (warp[..., None] >> 2) + 16 * (warp[..., None] & 3) + g[:, None] + 8 * hf_i
    row, col = j // 4, 8 * (j % 4) + 2 * q[:, None] + c_i
    for t0 in range(0, nblk * nm * E, chunk):
        e, m0, y0, x0 = (v[:, None, None] for v in
                         tile_at(torch.arange(t0, min(t0 + chunk, nblk * nm * E)), nblk, nm, ncols))
        T = e.shape[0]
        acc = vol[e[..., None], m0[..., None] + pix, y0[..., None] + row, x0[..., None] + col]
        acc = acc.to(torch.bfloat16).float()          # [T, 8, 32, 128]
        pw = m0 + 64 * (warp >> 2) + 16 * (warp & 3)   # the warp's first pixel, [T, 8, 1]
        # level 0: pairs of columns, transposed in each quad, 16 bytes a lane
        for r in range(ROWS):
            for hf in range(2):
                idx = [4 * (4 * r + cj) + 2 * hf for cj in range(4)]
                w = torch.stack([_pack(acc[..., k], acc[..., k + 1]) for k in idx], -1)
                w = _quad_transpose(w)
                p, y, x = pw + g + 8 * hf, y0 + r, x0 + 8 * q
                live = (p < P) & (y < H0) & (x < W0)
                cells = [h for k in range(4) for h in _halves(w[..., k])]
                if W0 % 8 == 0:
                    mem.store(0, live, e, p, y, x, cells)
                else:
                    for k in range(8):
                        mem.store(0, live & (x + k < W0), e, p, y, x + k, [cells[k]])
        # level 1 staged: [tile, warp, 16 pixels, 4 rows, 16 columns]
        stg = torch.zeros(T, WARPS, 16, 4, 16)
        tix = torch.arange(T)[:, None, None]
        for hf in range(2):
            for r1 in range(4):
                for cj in range(4):
                    i0 = 4 * (8 * r1 + cj) + 2 * hf
                    i1 = i0 + 16
                    s = (((acc[..., i0] + acc[..., i0 + 1]) + acc[..., i1]) + acc[..., i1 + 1])
                    stg[tix, warp, g + 8 * hf, r1, 4 * cj + q] = \
                        (s * 0.25).to(torch.bfloat16).float()
        for u in range(2):
            it = lane + 32 * u
            lp, qq = it >> 2, it & 3
            p = pw + lp
            live = p < P
            cols = 4 * qq[:, None] + torch.arange(4)
            l1 = [stg[tix[..., None], warp[..., None], lp[:, None], r1, cols]
                  for r1 in range(4)]                  # [T, 8, 32, 4]
            l2 = [[((((a[..., 2 * c] + a[..., 2 * c + 1]) + b[..., 2 * c]) + b[..., 2 * c + 1])
                    * 0.25).to(torch.bfloat16).float() for c in range(2)]
                  for a, b in (l1[0:2], l1[2:4])]
            l3 = ((((l2[0][0] + l2[0][1]) + l2[1][0]) + l2[1][1]) * 0.25).to(torch.bfloat16).float()
            x1, x2, x3 = (x0 >> 1) + 4 * qq, (x0 >> 2) + 2 * qq, (x0 >> 3) + qq
            for r1 in range(4):
                y = (y0 >> 1) + r1
                ok = live & (y < Hl1) & (x1 < Wl1)
                cells = [_bits(l1[r1][..., k]) for k in range(4)]
                if Wl1 % 4 == 0:
                    mem.store(1, ok, e, p, y, x1, cells)
                else:
                    for k in range(4):
                        mem.store(1, ok & (x1 + k < Wl1), e, p, y, x1 + k, [cells[k]])
            b0, b1 = (qq & 1).bool(), (qq & 2).bool()
            if Wl2 % 8 == 0:
                w0, w1 = _pack(l2[0][0], l2[0][1]), _pack(l2[1][0], l2[1][1])
                pr = _shfl_xor(torch.where(b0, w0, w1), 1)
                h0, h1 = torch.where(b0, pr, w0), torch.where(b0, w1, pr)
                o0, o1 = _shfl_xor(h0, 2), _shfl_xor(h1, 2)
                y = (y0 >> 2) + qq
                ok = ~b1 & live & (y < Hl2) & ((x0 >> 2) < Wl2)
                cells = [h for v in (h0, h1, o0, o1) for h in _halves(v)]
                mem.store(2, ok, e, p, y, x0 >> 2, cells)
            else:
                for r2 in range(2):
                    y = (y0 >> 2) + r2
                    ok = live & (y < Hl2) & (x2 < Wl2)
                    cells = [_bits(l2[r2][0]), _bits(l2[r2][1])]
                    if Wl2 % 2 == 0:
                        mem.store(2, ok, e, p, y, x2, cells)
                    else:
                        mem.store(2, ok, e, p, y, x2, cells[:1])
                        mem.store(2, ok & (x2 + 1 < Wl2), e, p, y, x2 + 1, cells[1:])
            if Wl3 % 4 == 0:
                o = _shfl_xor(l3, 1)
                w = torch.where(b0, _pack(o, l3), _pack(l3, o))
                v = _shfl_xor(w, 2)
                ok = (qq == 0) & live & ((y0 >> 3) < Hl3) & ((x0 >> 3) < Wl3)
                mem.store(3, ok, e, p, y0 >> 3, x0 >> 3, _halves(w) + _halves(v))
            else:
                ok = live & ((y0 >> 3) < Hl3) & (x3 < Wl3)
                mem.store(3, ok, e, p, y0 >> 3, x3, [_bits(l3)])
    return mem


def tile_at(t, nblk, nm, ncols):
    """The kernel's tile_at: tile t -> (e, m0, y0, x0), the cell block
    fastest, then the pixel block, then the edge."""
    cb, mt = t % nblk, t // nblk
    return mt // nm, (mt % nm) * KM, (cb // ncols) * ROWS, (cb % ncols) * COLS


@pytest.mark.parametrize("E,H,W", TILE_SHAPES, ids=TILE_IDS)
def test_k2_bf16_store_map_writes_the_plain_levels_bit_for_bit(E, H, W):
    f1, f2 = (f.to(torch.bfloat16) for f in _features(E, H, W, 8, 3))
    mem = bf16_tile_path(f1, f2)
    plain = corr_build_plain(f1, f2, torch.bfloat16)
    for l, ref in enumerate(plain):
        assert bool((mem.count[l] == 1).all()), f"a cell of level {l} is written other than once"
        assert torch.equal(mem.bits[l], _bits(ref.float()).reshape(-1)), l


def schedule(tiles, sms=SMS):
    """The kernel's schedule() and its tile(k): per block, the tiles it takes
    in order, block b tiles b, b + G, b + 2 G, ... of G = min(tiles, sms)."""
    blocks = min(tiles, sms)
    per, extra = divmod(tiles, blocks)
    return [[b + k * blocks for k in range(per + (b < extra))] for b in range(blocks)]


def ring(count, nk, stages):
    """A block's items through the ring, in its program order: thread 0
    loads items 0 .. stages - 1, then for each item n the block waits on
    stage n % stages with parity (n // stages) & 1, runs the products,
    synchronises, loads item n + stages, and after a tile's last chunk runs
    its epilogue.  Returns, per tile, the items loaded before its epilogue;
    asserts that no stage is loaded while it holds an item not yet
    consumed and that every wait finds its item in the phase it names."""
    items = count * nk
    held, phases, issued = {}, [0] * stages, []

    def load(n):
        s = n % stages
        assert s not in held, f"item {n} loaded into stage {s} before item {held.get(s)} was consumed"
        held[s] = n
        phases[s] += 1
        issued.append(n)

    for n in range(min(stages, items)):
        load(n)
    before_epilogue = []
    for n in range(items):
        s = n % stages
        assert held.get(s) == n and (phases[s] - 1) & 1 == (n // stages) & 1, (n, held, phases)
        del held[s]                                   # consumed: the products of item n
        if n + stages < items:
            load(n + stages)
        if n % nk == nk - 1:
            before_epilogue.append(set(issued))
    return before_epilogue


def _tiles(E, H, W):
    return -(-W // COLS) * -(-H // ROWS) * -(-(H * W) // KM) * E


SCHEDULE_SHAPES = [(1, 40, 64), (48, 40, 64), (64, 40, 64), (4, 30, 44), (2, 60, 80),
                   (2, 48, 120), (2, 30, 45), (2, 24, 34), (2, 24, 66)]
SCHEDULE_IDS = ["E1", "E48", "EB64", "30x44", "60x80", "48x120", "30x45", "24x34", "24x66"]


@pytest.mark.parametrize("E,H,W", SCHEDULE_SHAPES, ids=SCHEDULE_IDS)
def test_k2_bf16_schedule_takes_every_tile_once(E, H, W):
    tiles = _tiles(E, H, W)
    blocks = schedule(tiles)
    assert len(blocks) == min(tiles, SMS)
    assert sorted(t for b in blocks for t in b) == list(range(tiles))   # each tile once
    counts = [len(b) for b in blocks]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1
    for k in range(max(counts)):
        # the k-th tiles of all blocks are neighbours, as one block a tile
        # would run them
        kth = [b[k] for b in blocks if k < len(b)]
        assert kth == list(range(k * len(blocks), k * len(blocks) + len(kth)))
    ncols, nblk, nm = -(-W // COLS), -(-W // COLS) * -(-H // ROWS), -(-(H * W) // KM)
    cover = {tile_at(t, nblk, nm, ncols) for t in range(tiles)}
    assert cover == {(e, m0, y0, x0) for e in range(E) for m0 in range(0, H * W, KM)
                     for y0 in range(0, H, ROWS) for x0 in range(0, W, COLS)}
    assert [tile_at(t, nblk, nm, ncols)[2:] for t in range(nblk)] == \
        [(y0, x0) for y0 in range(0, H, ROWS) for x0 in range(0, W, COLS)]   # cells fastest


@pytest.mark.parametrize("E,H,W", SCHEDULE_SHAPES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("C,stages", [(128, 2), (128, 3), (64, 2), (192, 2)],
                         ids=["C128-S2", "C128-S3", "C64-S2", "C192-S2"])
def test_k2_bf16_ring_loads_a_stage_only_once_consumed(E, H, W, C, stages):
    nk = -(-C // 64)
    for block in schedule(_tiles(E, H, W)):
        count = len(block)
        before = ring(count, nk, stages)
        for i in range(count - 1):
            # the next tile's chunks that fit the ring are in flight during
            # this tile's epilogue
            nxt = set(range((i + 1) * nk, min((i + 1) * nk + stages, (i + 2) * nk)))
            assert nxt <= before[i], (i, sorted(before[i]))

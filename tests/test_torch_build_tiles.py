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

"""Keyframe-sharded dense bundle adjustment (mirror of the JAX package's
parallel/dist_ba.py).

The window's depth buckets are split into contiguous per-shard ranges with
about equal EDGE counts (``partition_edges``); every edge lives on the shard
that owns its source frame's bucket, so each shard builds its edges' GN
blocks (K1, ``ops.cuda_ba.ba_system_blocks``, once per iteration) and
eliminates its own depths (the Schur step) alone.  Only the 6MW pose system
is exchanged, in one of two ways (``exchange``):

- ``"gather_root"``: the per-edge pose blocks and the per-bucket Schur
  blocks are gathered in their block-sparse form to shard 0, which alone
  assembles the dense system and runs the damped Cholesky; dx is broadcast;
- ``"dense_psum"``: each shard scatters its own blocks into the dense
  [MW, MW, 6, 6] Hessian and Schur tensors, the dense tensors are summed
  over the shards, and every device solves.

The collectives are calls on an exchange object: ``LocalExchange`` runs
every shard in this process, on the mesh's devices, in shard order (sums
taken in shard order on shard 0's device, so results do not depend on
timing); ``GroupExchange`` runs one shard per rank of a torch.distributed
group.  Replicated state (poses, the padded disparities) is kept once per
device.  Results equal ``ba.solver.ba_iterations`` up to the order of the
sums.
"""
import numpy as np
import torch

from ..ba.solver import _damped_solve, _mask_fixed, _pose_matrix, _scatter_blocks, schur_pairs
from ..lie import se3_retr
from ..ops.cuda_ba import ba_system_blocks

EXCHANGES = ("gather_root", "dense_psum")
# resolve_exchange's choice on CUDA.  On one H100 at MW = 128, 40x64 the two
# exchanges tie within their run-to-run spread (chip_smoke.py's parallel phase;
# PERF.md), so this follows the JAX package's TPU choice
CUDA_EXCHANGE = "dense_psum"


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def partition_edges(ii, jj, target, weight, MW, n_shards, edge_bucket=8):
    """Host-side: split [0, MW) into contiguous bucket ranges with ~equal
    EDGE counts and group edges by owning shard (the JAX function, line for
    line).

    Each shard's edge list is padded to the common bucketed length with
    (first-owned-bucket, first-owned-bucket) zero-weight self-edges; bucket
    tables are local (rows = owned buckets, padded to the longest range).
    target/weight are tensors, gathered on their own device.

    Returns (ii_s, jj_s, tgt_s, wgt_s, be_s, bm_s, k0, rlen) with a leading
    shard axis on the first six and per-shard range start/length in the
    last two ([S] int32 each).
    """
    if MW < n_shards:
        raise ValueError(f"a window of {MW} frames cannot hold {n_shards} shards")
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    nE = len(ii)

    counts = np.bincount(ii, minlength=MW) if nE else np.zeros(MW, np.int64)
    cum = np.cumsum(counts)
    bounds = [0]
    for s in range(1, n_shards):
        tgt = int(round(s * nE / n_shards))
        b = int(np.searchsorted(cum, tgt))
        b = max(b, bounds[-1] + 1)          # at least one bucket per shard
        b = min(b, MW - (n_shards - s))     # leave buckets for later shards
        bounds.append(b)
    bounds.append(MW)
    k0 = np.asarray(bounds[:-1], np.int32)
    k1 = np.asarray(bounds[1:], np.int32)
    rlen = (k1 - k0).astype(np.int32)
    max_range = int(rlen.max())

    groups = [np.where((ii >= k0[s]) & (ii < k1[s]))[0] for s in range(n_shards)]
    n_max = max(max((len(g) for g in groups), default=1), 1)
    n_max = _round_up(n_max, edge_bucket)
    Rmax = int(counts.max()) if nE else 1
    Rmax = max(Rmax, 1)

    ii_s = np.zeros((n_shards, n_max), np.int32)
    jj_s = np.zeros((n_shards, n_max), np.int32)
    tgt_s = target.new_zeros((n_shards, n_max) + tuple(target.shape[1:]))
    wgt_s = weight.new_zeros((n_shards, n_max) + tuple(weight.shape[1:]))
    be_s = np.zeros((n_shards, max_range, Rmax), np.int32)
    bm_s = np.zeros((n_shards, max_range, Rmax), bool)
    for s, g in enumerate(groups):
        n = len(g)
        ii_s[s, :n] = ii[g]
        jj_s[s, :n] = jj[g]
        ii_s[s, n:] = k0[s]  # padding anchored in the first owned bucket
        jj_s[s, n:] = k0[s]
        if n:
            sel = torch.as_tensor(g, device=target.device)
            tgt_s[s, :n] = target[sel]
            wgt_s[s, :n] = weight[sel]
        # Rmax bounds the REAL per-bucket degree; padded edges land in
        # bucket k0 AFTER the real ones, so truncation at Rmax can only
        # ever drop zero-weight padding, never a real edge
        be, bm = schur_pairs(ii_s[s] - k0[s], int(rlen[s]), max_deg=Rmax)
        be_s[s, : rlen[s]] = be
        bm_s[s, : rlen[s]] = bm
        # padded edges carry zero weight, but keep the mask exact
        bm_s[s] &= be_s[s] < max(n, 1)
        if n == 0:
            bm_s[s] &= False
    return ii_s, jj_s, tgt_s, wgt_s, be_s, bm_s, k0, rlen


def resolve_exchange(exchange="auto", device=None):
    """'auto' -> CUDA_EXCHANGE for a CUDA `device` (the default when a card
    is visible), gather_root on the CPU (a serial scatter is cheap there and
    replicating it across shared cores is not)."""
    if exchange != "auto":
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be 'auto' or one of {EXCHANGES}, got {exchange!r}")
        return exchange
    device = torch.device(device if device is not None
                          else "cuda" if torch.cuda.is_available() else "cpu")
    return CUDA_EXCHANGE if device.type == "cuda" else "gather_root"


class LocalExchange:
    """Every shard of `mesh` in this process.  Sums are taken in shard
    order on shard 0's device; results are handed to each distinct device
    once (``devices``)."""

    def __init__(self, mesh):
        self.shards, self.shard_devices = list(mesh.shards), list(mesh.devices)
        self.devices = list(dict.fromkeys(mesh.devices))
        self.root = mesh.devices[0]
        self.holds_root = True

    def _spread(self, x):
        return {d: x.to(d) for d in self.devices}

    def psum(self, xs):
        """{device: sum over shards} of the per-shard tensors xs."""
        acc = xs[0].to(self.root)
        for x in xs[1:]:
            acc = acc + x.to(self.root)
        return self._spread(acc)

    def all_gather(self, xs):
        """{device: [S, ...] stack of the per-shard tensors xs}."""
        return self._spread(torch.stack([x.to(self.root) for x in xs]))

    def gather(self, xs):
        """The [S, ...] stack on shard 0's device (None off shard 0)."""
        return torch.stack([x.to(self.root) for x in xs])

    def broadcast(self, x, like):
        """{device: shard 0's x}."""
        return self._spread(x)


class GroupExchange:
    """One shard per rank of the torch.distributed group of `mesh`; shard 0
    is the group's rank 0."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.dist, self.group = dist, mesh.group
        self.shards, self.shard_devices = list(mesh.shards), list(mesh.devices)
        self.devices = list(mesh.devices)
        self.holds_root = mesh.shards[0] == 0
        self.src = dist.get_global_rank(mesh.group, 0)
        self.world = dist.get_world_size(mesh.group)

    def psum(self, xs):
        x = xs[0].clone()
        self.dist.all_reduce(x, group=self.group)
        return {self.devices[0]: x}

    def all_gather(self, xs):
        out = [torch.empty_like(xs[0]) for _ in range(self.world)]
        self.dist.all_gather(out, xs[0].contiguous(), group=self.group)
        return {self.devices[0]: torch.stack(out)}

    def gather(self, xs):
        out = [torch.empty_like(xs[0]) for _ in range(self.world)] if self.holds_root else None
        self.dist.gather(xs[0].contiguous(), out, dst=self.src, group=self.group)
        return torch.stack(out) if self.holds_root else None

    def broadcast(self, x, like):
        buf = x.contiguous() if self.holds_root else torch.empty_like(like)
        self.dist.broadcast(buf, src=self.src, group=self.group)
        return {self.devices[0]: buf}


def make_exchange(mesh):
    return GroupExchange(mesh) if mesh.group is not None else LocalExchange(mesh)


def _host_ints(x):
    return np.asarray(x.cpu() if torch.is_tensor(x) else x).astype(np.int64)


def _shard_tensor(x, s, dev, dtype=None):
    """Shard s of a leading-shard-axis array (numpy or tensor) on dev."""
    x = x[s]
    x = torch.as_tensor(np.ascontiguousarray(x)) if not torch.is_tensor(x) else x
    return x.to(device=dev, dtype=dtype or x.dtype).contiguous()


def _shard_blocks(poses, disps_pad, dsens_pad, eta_pad, intr, free_mask, sh, MW, max_range,
                  alpha, min_depth):
    """One shard's part of a GN iteration before the exchange (JAX
    dist_ba.py:222-287): its edges' blocks (K1), its pose rhs, and its
    depth buckets' Schur blocks."""
    ii, jj, be, bm, k0, rlen = sh["ii"], sh["jj"], sh["be"], sh["bm"], sh["k0"], sh["rlen"]
    dev = ii.device
    H, W = disps_pad.shape[-2:]
    HW = H * W
    disps = disps_pad[:MW]
    blk = ba_system_blocks(sh["target"], sh["weight"], poses, disps, intr, ii, jj,
                           min_depth=min_depth)

    v = poses.new_zeros(MW, 6).index_add_(0, ii, blk["vi"]).index_add_(0, jj, blk["vj"])

    # local depth buckets (global ii -> local row = ii - k0)
    ii_loc = ii - k0
    C = disps.new_zeros(max_range, HW).index_add_(0, ii_loc, blk["Ck"])
    w = disps.new_zeros(max_range, HW).index_add_(0, ii_loc, blk["wk"])
    rows = slice(k0, k0 + max_range)
    dsens_l = dsens_pad[rows].reshape(max_range, HW)
    dloc = disps_pad[rows].reshape(max_range, HW)
    m = (dsens_l > 0).to(C.dtype)
    C = C + m * alpha + (1.0 - m) * eta_pad[rows].reshape(max_range, HW)
    w = w - m * alpha * (dloc - dsens_l)
    Q = 1.0 / C

    rows_real = torch.arange(max_range, device=dev) < rlen
    A_rows = disps.new_zeros(max_range, 6, HW).index_add_(0, ii_loc, blk["Ei"])
    Gedges = blk["Ej"][be] * bm[..., None, None]
    G = torch.cat([A_rows[:, None], Gedges], dim=1)                   # [M, R+1, 6, HW]
    pose_idx = torch.cat([(torch.arange(max_range, device=dev) + k0)[:, None], jj[be]], dim=1)
    pose_idx = pose_idx.clamp(0, MW - 1)
    row_ok = (torch.cat([torch.ones_like(bm[:, :1]), bm], dim=1) & free_mask[pose_idx]
              & rows_real[:, None])
    R1 = G.shape[1]

    GQ = G * Q[:, None, None, :]
    Sk = torch.bmm(GQ.reshape(max_range, R1 * 6, HW),
                   G.reshape(max_range, R1 * 6, HW).transpose(1, 2))
    Sk = Sk.reshape(max_range, R1, 6, R1, 6).permute(0, 1, 3, 2, 4)   # [M, R1, R1, 6, 6]
    pair_ok = row_ok[:, :, None] & row_ok[:, None, :]
    Ew = torch.bmm(GQ.reshape(max_range, R1 * 6, HW), w[:, :, None]).reshape(max_range, R1, 6)
    Ew = torch.where(row_ok[..., None], Ew, torch.zeros_like(Ew))
    vE = poses.new_zeros(MW + 1, 6).index_add_(
        0, torch.where(row_ok, pose_idx, torch.full_like(pose_idx, MW)).reshape(-1),
        Ew.reshape(-1, 6))[:MW]

    return {
        "v": v, "vE": vE, "Q": Q, "w": w, "G": G, "pose_idx": pose_idx, "row_ok": row_ok,
        "rows_real": rows_real, "Sk": Sk, "pair_ok": pair_ok,
        "blocks": torch.stack([blk["Hii"], blk["Hij"], blk["Hji"], blk["Hjj"]], 0),
        "bi": torch.stack([ii, ii, jj, jj], 0), "bj": torch.stack([ii, jj, ii, jj], 0),
    }


def _solve_pose(Hmat, Smat, v, vE, free, free6, MW, lm, ep):
    """The damped pose step from the summed Hessian and Schur blocks."""
    S_pose = _mask_fixed(_pose_matrix(Hmat, MW), free6) - _pose_matrix(Smat, MW)
    rhs = v.reshape(6 * MW) - (vE * free[:, None]).reshape(6 * MW)
    return _damped_solve(S_pose, rhs, lm, ep)


def _expand_pairs(pose_idx):
    R1 = pose_idx.shape[-1]
    shape = pose_idx.shape + (R1,)
    return pose_idx[..., :, None].expand(shape), pose_idx[..., None, :].expand(shape)


def dist_ba_solve(mesh, poses, disps, intrinsics, disps_sens, target_s, weight_s, eta, ii_s,
                  jj_s, free_mask, bucket_edges_s, bucket_mask_s, k0_s, rlen_s, iterations=2,
                  lm=1e-4, ep=0.1, alpha=0.05, min_depth=0.25, axis="kf",
                  exchange="gather_root"):
    """Distributed windowed BA.  poses [MW, 7], disps/disps_sens/eta
    [MW, H, W], intrinsics [4] and free_mask [MW] are replicated; the *_s
    arrays (numpy or tensors) carry a leading shard axis from
    ``partition_edges``.  Each shard of `mesh` (make_mesh) runs on its
    device; ``exchange`` must be resolved (resolve_exchange).  Returns the
    updated (poses, disps) on the device of `poses`.  `axis` names the
    mesh's axis, as in the JAX function; the mesh has one.

    As in the JAX function, the poses are retracted inside each iteration,
    and each shard's dz rows are added to the padded disparity buffer after
    it.
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES} (resolve 'auto' first), "
                         f"got {exchange!r}")
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has axes {mesh.axis_names}, not {axis!r}")
    ex = make_exchange(mesh)
    MW = poses.shape[0]
    H, W = disps.shape[-2:]
    n_shards = mesh.size
    if len(k0_s) != n_shards:
        raise ValueError(f"{len(k0_s)} shards of edges for a mesh of {n_shards}")
    max_range = int(bucket_edges_s.shape[1])
    k0_h, rlen_h = _host_ints(k0_s), _host_ints(rlen_s)
    out_dev = poses.device

    # replicated state, once per device; the depth-side arrays padded by
    # max_range rows so that every shard slices a full [k0, k0 + max_range)
    rep = {}
    for d in ex.devices:
        zpad = torch.zeros(max_range, H, W, device=d)
        rep[d] = {
            "poses": poses.to(d).contiguous(),
            "disps_pad": torch.cat([disps.to(d), zpad], 0),
            "dsens_pad": torch.cat([disps_sens.to(d), zpad], 0),
            "eta_pad": torch.cat([eta.to(d), torch.ones_like(zpad)], 0),
            "intr": intrinsics.to(d).reshape(4).contiguous(),
            "free_mask": torch.as_tensor(free_mask).to(d, torch.bool),
        }
        rep[d]["free"] = rep[d]["free_mask"].float()
        rep[d]["free6"] = rep[d]["free"].repeat_interleave(6)

    shards = []
    for s, dev in zip(ex.shards, ex.shard_devices):
        shards.append({
            "dev": dev, "k0": int(k0_h[s]), "rlen": int(rlen_h[s]),
            "target": _shard_tensor(target_s, s, dev, torch.float32),
            "weight": _shard_tensor(weight_s, s, dev, torch.float32),
            "ii": _shard_tensor(ii_s, s, dev, torch.int64),
            "jj": _shard_tensor(jj_s, s, dev, torch.int64),
            "be": _shard_tensor(bucket_edges_s, s, dev, torch.int64),
            "bm": _shard_tensor(bucket_mask_s, s, dev, torch.bool),
        })

    for _ in range(iterations):
        loc = [_shard_blocks(rep[sh["dev"]]["poses"], rep[sh["dev"]]["disps_pad"],
                             rep[sh["dev"]]["dsens_pad"], rep[sh["dev"]]["eta_pad"],
                             rep[sh["dev"]]["intr"], rep[sh["dev"]]["free_mask"], sh, MW,
                             max_range, alpha, min_depth) for sh in shards]
        v = ex.psum([lo["v"] for lo in loc])
        vE = ex.psum([lo["vE"] for lo in loc])

        if exchange == "dense_psum":
            # each shard scatters its own blocks densely; the dense tensors
            # are summed over the shards and every device solves
            HS = ex.psum([torch.stack([
                _scatter_blocks(lo["blocks"], lo["bi"], lo["bj"],
                                torch.ones_like(lo["bi"], dtype=torch.bool), MW),
                _scatter_blocks(lo["Sk"], *_expand_pairs(lo["pose_idx"]), lo["pair_ok"], MW)])
                for lo in loc])
            dx = {d: _solve_pose(HS[d][0], HS[d][1], v[d] * r["free"][:, None], vE[d],
                                 r["free"], r["free6"], MW, lm, ep) for d, r in rep.items()}
        else:
            # block-sparse gathers; shard 0 alone assembles and solves, then
            # broadcasts dx
            blocks_g = ex.gather([lo["blocks"] for lo in loc])
            bi_g = ex.gather([lo["bi"] for lo in loc])
            bj_g = ex.gather([lo["bj"] for lo in loc])
            Sk_g = ex.gather([lo["Sk"] for lo in loc])
            pi_g = ex.gather([lo["pose_idx"] for lo in loc])
            ok_g = ex.gather([lo["pair_ok"] for lo in loc])
            dx_root = None
            if ex.holds_root:
                r = rep[ex.devices[0]]
                Hmat = _scatter_blocks(blocks_g, bi_g, bj_g,
                                       torch.ones_like(bi_g, dtype=torch.bool), MW)
                Smat = _scatter_blocks(Sk_g, *_expand_pairs(pi_g), ok_g, MW)
                d0 = ex.devices[0]
                dx_root = _solve_pose(Hmat, Smat, v[d0] * r["free"][:, None], vE[d0],
                                      r["free"], r["free6"], MW, lm, ep)
            dx = ex.broadcast(dx_root, like=v[ex.devices[0]].reshape(6 * MW))

        # local depth back-substitution
        dz = []
        for sh, lo in zip(shards, loc):
            r = rep[sh["dev"]]
            dxs = dx[sh["dev"]].reshape(MW, 6) * r["free"][:, None]
            dx_rows = torch.where(lo["row_ok"][..., None], dxs[lo["pose_idx"]],
                                  torch.zeros_like(dxs[lo["pose_idx"]]))
            R1 = lo["G"].shape[1]
            Etdx = torch.bmm(dx_rows.reshape(max_range, 1, R1 * 6),
                             lo["G"].reshape(max_range, R1 * 6, H * W))[:, 0]
            dz.append((lo["Q"] * (lo["w"] - Etdx)
                       * lo["rows_real"][:, None].to(lo["Q"].dtype)).reshape(max_range, H, W))
        dz_all = ex.all_gather(dz)
        for d, r in rep.items():
            dxs = dx[d].reshape(MW, 6) * r["free"][:, None]
            r["poses"] = se3_retr(r["poses"], dxs)
            disps_pad = r["disps_pad"]
            for s in range(n_shards):
                k0 = int(k0_h[s])
                disps_pad = disps_pad.index_add(
                    0, torch.arange(k0, k0 + max_range, device=d), dz_all[d][s])
            r["disps_pad"] = disps_pad
    r = rep[ex.devices[0]]
    return r["poses"].to(out_dev), r["disps_pad"][:MW].to(out_dev)


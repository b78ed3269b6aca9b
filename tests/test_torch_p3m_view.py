"""P3M's view kernel and the near sweep's rows of the PyTorch port, on the
CPU: what of them runs on the host, and the view kernel's ordering rule.

  * The view's buffer (``ops.cuda_p3m._View``, ``_layout``): every entry of
    ``p3m_short_view`` at its shape and dtype, 16-byte aligned, apart from
    the others, its address without making its tensor.
  * The view kernel's order (``csrc/p3m_short.cu`` ``p3m_view_kernel``,
    mirrored here in numpy as it computes it: each cell's box, each row's
    Morton key, its place by comparison in a cell of up to 32 rows, or its
    rank among the earlier rows of its key taken 32 rows at a time with a
    histogram and the histogram's exclusive prefix, and the cells' offsets
    from the counts before them) equal to the plain view in
    the kernel's order (a stable sort), on tables with an empty cell, cells
    at capacity, one-row cells, cells past 32 rows and coincident bodies.
  * The near sweep's rows: the plain ``near_acc_slots(i0=)`` of each rank,
    and the rows wrapper's CPU path given the rank's rows of the table,
    bit-equal to the same rows of the whole plain sweep,
    at a rank count that does not divide the chunk budget (the last rank
    takes the rest) and with ranks that hold no live chunk (the budget's
    headroom).
Everything is compared equal, bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from orbital_tpu_torch.ops import cuda_neighbor as cn
from orbital_tpu_torch.ops import cuda_p3m
from orbital_tpu_torch.ops import neighbor as tn
from orbital_tpu_torch.ops import p3m as tp3m

# pytest-xdist workers share the cores: one full set of torch's spinning
# OpenMP threads a worker made the suite ~25x slower than a worker's share
torch.set_num_threads(max(1, (os.cpu_count() or 1)
                          // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

F32 = np.float32


@pytest.mark.parametrize("with_gid", [False, True])
def test_view_buffer_layout(with_gid):
    n, gc3, room = 1001, 27, 60
    v = cuda_p3m._View(n, gc3, room, with_gid, torch.device("cpu"))
    want = {"rows": (torch.float32, (n, 4)), "body": (torch.int64, (n,)),
            "run_off": (torch.int32, (gc3, 9)), "run_box": (torch.float32, (gc3, 8, 6)),
            "slices": (torch.int32, (room,)), "nslices": (torch.int32, (3,))}
    if with_gid:
        want["gid"] = (torch.int64, (n,))
    assert set(v) == set(want) and len(v) == len(want) and v.room == room
    assert (v.ptr("gid") is None) == (not with_gid)
    spans = []
    for k, (dtype, shape) in want.items():
        p = v.ptr(k)
        assert p % 16 == 0
        t = v[k]
        assert t is v[k] and t.dtype == dtype and tuple(t.shape) == shape
        assert t.data_ptr() == p and t.is_contiguous() and t.device.type == "cpu"
        spans.append((p, p + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def _mirror_view(tab, gc, n, gid):
    """The view kernel's arithmetic in numpy: a cell's kept rows, their box
    and keys in float32 as the kernel forms them, each row's place (in a
    cell of up to 32 rows its count of smaller keys and of equal keys
    before it; in a larger one the key histogram's prefix and its rank
    among the earlier rows of its key, 32 rows at a time, as a warp takes
    them), the cell's offsets from the counts before it."""
    count = tab["count"].numpy().astype(np.int64)
    cap = tab["table"].shape[1]
    pos = tab["cell_pos"].numpy().reshape(-1, cap, 3)
    mass = tab["cell_m"].numpy().reshape(-1, cap)
    table = tab["table"].numpy().reshape(-1, cap)
    rows = np.zeros((n, 4), F32)
    body = np.full(n, n, np.int64)
    gid_s = np.full(n, -1, np.int64)
    run_off = np.zeros((gc ** 3, 9), np.int32)
    run_box = np.zeros((gc ** 3, 8, 6), F32)
    slices = []
    start = 0
    for c in range(gc ** 3):
        cnt = int(count[c])
        x = pos[c, :cnt]
        lo = x.min(0) if cnt else np.full(3, np.inf, F32)
        hi = x.max(0) if cnt else np.full(3, -np.inf, F32)
        with np.errstate(invalid="ignore", over="ignore"):
            scale = F32(8.0) / np.maximum(hi - lo, F32(1e-30))
            q = np.clip(np.floor((x - lo) * scale), 0, 7).astype(np.int64)
        spread = (q & 1) | ((q & 2) << 2) | ((q & 4) << 4)
        key = (spread[:, 0] << 2) | (spread[:, 1] << 1) | spread[:, 2]
        if cnt <= 32:
            # one warp's rows: smaller keys and equal keys before, compared
            place = np.array([np.sum(key < kk) + np.sum(key[:i] == kk)
                              for i, kk in enumerate(key)], np.int64)
            first = np.array([np.sum(key < o) for o in range(512)], np.int64)
        else:
            hist = np.zeros(512, np.int64)
            rank = np.zeros(cnt, np.int64)
            for k0 in range(0, cnt, 32):
                grp = key[k0:k0 + 32]
                for i, kk in enumerate(grp):
                    rank[k0 + i] = hist[kk] + int(np.sum(grp[:i] == kk))
                np.add.at(hist, grp, 1)
            first = np.concatenate([[0], np.cumsum(hist)[:-1]])
            place = first[key] + rank
        dst = start + place
        rows[dst, :3], rows[dst, 3] = x, mass[c, :cnt]
        body[dst] = table[c, :cnt]
        if gid is not None:
            gid_s[dst] = gid.numpy()[table[c, :cnt]]
        run_off[c] = start + np.append(first[::64], cnt)
        box = np.concatenate([np.full((8, 3), np.inf, F32), np.full((8, 3), -np.inf, F32)], 1)
        for o in range(8):
            xo = x[(key >> 6) == o]
            if len(xo):
                box[o, :3], box[o, 3:] = xo.min(0), xo.max(0)
        run_box[c] = box
        slices += [(c << 9) | k for k in range(-(-cnt // 32))]
        start += cnt
    return dict(rows=rows, body=body, gid=gid_s, run_off=run_off, run_box=run_box,
                slices=np.array(slices, np.int32), kept=start)


def _table(capacity_scale):
    """A uniform cloud with a dense core, a run of coincident bodies (one
    key), a lone body in a corner cell and an empty corner cell (4^3 cells
    of 2 over the box (0, 0, 0, 4)); capacity
    the fullest cell's (``capacity_scale`` 1) or half of it (starved: cells
    cut at capacity)."""
    rng = np.random.default_rng(21)
    n = 1500
    pos = rng.uniform(-4, 4, (n, 3)).astype(F32)
    pos[:400] *= F32(0.2)
    pos[400:440] = F32(1.3)                                  # coincident: one key
    # the grid's cells are 2 wide: empty the (+, +, +) corner cell and leave
    # one body in the (-, -, -) one
    for sign in (1.0, -1.0):
        pos[((sign * pos) > 2.0).all(1)] = F32(0.5)
    pos[440] = F32(-3.95)
    mass = rng.uniform(0.5, 1.5, n).astype(F32) / n
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    alive = torch.ones(n, dtype=torch.bool)
    center, half = torch.zeros(3), torch.tensor(4.0)
    gc = tp3m._cell_grid(32, 1.5, 4.5)
    occ = tp3m.p3m_max_occupancy(p, alive, grid=32, box=(center, half))
    tab = tp3m.p3m_cell_table(p, m, alive, center, half, gc=gc,
                              capacity=max(1, int(occ * capacity_scale)))
    return tab, gc, n, occ


@pytest.mark.parametrize("capacity_scale", [1.0, 0.5], ids=["full", "starved"])
@pytest.mark.parametrize("with_gid", [False, True])
def test_view_kernel_order_equals_the_plain_view(capacity_scale, with_gid):
    tab, gc, n, occ = _table(capacity_scale)
    count = tab["count"].numpy()
    cap = tab["table"].shape[1]
    assert occ > 64 and count.min() == 0 and (count == 1).any() and (count == cap).any()
    gid = torch.arange(n) + 11 if with_gid else None
    got = _mirror_view(tab, gc, n, gid)
    want = cuda_p3m.p3m_short_view(tab, gc, n, gid)
    kept = got["kept"]
    assert kept == int(count.sum())
    assert np.array_equal(got["rows"][:kept], want["rows"][:kept].numpy())
    assert np.array_equal(got["body"][:kept], want["body"][:kept].numpy())
    if with_gid:
        assert np.array_equal(got["gid"][:kept], want["gid"][:kept].numpy())
    for k in ("run_off", "run_box", "slices"):
        assert np.array_equal(got[k], want[k].numpy()), k
    assert int(want["nslices"][0]) == len(got["slices"])


@pytest.fixture(scope="module")
def near_case():
    """A 400-body cluster's near geometry with a chunk budget of 2.2x the
    probe's (its tail chunks hold no live body) and packed f32 channels."""
    rng = np.random.default_rng(8)
    n, cell, chunk, rj = 400, 0.6, 8, 4
    pos = rng.normal(size=(n, 3))
    mass = rng.uniform(0.5, 1.5, n) / n
    m, k_ch, w_blk = tn.neighbor_budgets(pos, cell=cell, chunk=chunk, rj=rj, headroom=2.2)
    g = tn.neighbor_geometry(torch.tensor(pos, dtype=torch.float32),
                             torch.ones(n, dtype=torch.bool), cell=cell, m_grid=m, chunk=chunk,
                             max_chunks=k_ch, w_blk=w_blk, rj=rj)
    n_slots = (k_ch + rj) * chunk
    vals = [(pos[:, k], tn.SENTINEL_POS) for k in range(3)] + [(mass, 0.0)]
    ch = [tn.pack_slots(g["slot"], torch.tensor(v, dtype=torch.float32), n_slots, f)
          for v, f in vals]
    return dict(k_ch=k_ch, jbl=g["jbl"], ch=ch, chunk=chunk, rj=rj)


@pytest.mark.parametrize("ranks", [5, 7])
def test_plain_rows_of_every_rank_equal_the_whole_sweep(near_case, ranks):
    c = near_case
    kw = dict(r1=0.2, rc=0.4, G=1.0, eps2=1e-4, chunk=c["chunk"], rj=c["rj"])
    k_ch, chunk = c["k_ch"], c["chunk"]
    acc, pe = tn.near_acc_slots(*c["ch"], c["jbl"], **kw)
    kd = k_ch // ranks
    assert k_ch % ranks  # the last rank takes the rest
    live = (c["ch"][0][:k_ch * chunk].reshape(k_ch, chunk) < tn.SENTINEL_POS / 2).any(1)
    bounds = [(r * kd, (r + 1) * kd if r < ranks - 1 else k_ch) for r in range(ranks)]
    assert not bool(live[bounds[-1][0]:].any())  # a rank with no live chunk
    for i0, i1 in bounds:
        a, p = tn.near_acc_slots(*c["ch"], c["jbl"][i0:i1], i0=i0, **kw)
        assert torch.equal(a, acc[i0 * chunk:i1 * chunk])
        assert torch.equal(p, pe[i0 * chunk:i1 * chunk])
        # the wrapper, given the rank's rows as the sharded stepper slices them
        a, p = cn.near_acc_slots_rows_cuda(*c["ch"], c["jbl"][i0:i1], i0=i0, **kw)
        assert torch.equal(a, acc[i0 * chunk:i1 * chunk])
        assert torch.equal(p, pe[i0 * chunk:i1 * chunk])

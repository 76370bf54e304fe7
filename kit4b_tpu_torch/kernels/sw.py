"""Banded affine-gap Smith-Waterman: the row scan and the traceback.

`sw_scan` and `sw_traceback` launch the hand-written CUDA kernels of
`csrc/sw.cu` on CUDA tensors; they replace the XLA passes `_sw_scan` and
`_traceback_dev` of kit4b_tpu/pacbio/sswd.py. On CPU tensors they run
`sw_scan_plain` and `traceback_plain`, the plain PyTorch versions of the
same functions, which the tests hold against the JAX package and which the
on-card smoke test holds the kernels against.

The scan runs every one of the Lp probe rows of a pair (pad rows too) in a
band of W target columns that slides one column a row: row i, band index
k is target column `diag0 + i + k - W // 2`. It returns the best cell
(`best`, its row `bi` and band index `bk`, all 0 when no cell is
positive) and, with `traceback`, one pointer byte a cell in an
[Lp, B, W] uint8 array:

    bits 0-1  H0's source: 0 stop (H0 == 0), 1 diagonal (H0 == diag), 2 up
    bit 2     the cell's value came from F (F > H0)
    bit 3     E extends E above (e_ext >= e_open)
    bit 4     F extends F left (exclusive prefix max > the previous X)

The traceback walks that array from the best cell and returns the
reversed op codes (1 M, 2 D, 3 I; zero past n), n, the 1-based start row
and column, and the matches and mismatches of its M ops (the clipped codes
compared, so N against N counts as a match).

On the card the scan spreads each pair over a cluster of P blocks with C
band columns a thread (`scan_layout`), and the traceback walks with one
warp a pair over tiles of pointer bytes staged in shared memory; csrc/sw.cu
says how.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

NEG = -(1 << 24)
MAX_W = 8192     # widest band the scan kernel takes: 32 warps of 8 columns
CLUSTER_SIZES = tuple(range(1, 9))   # blocks a pair: 8, the portable limit
THREAD_COLS = (2, 4, 8)          # band columns a thread
MAX_WARPS = 32                   # a pair's warps: one exchange slot a lane
MAX_BLOCK_THREADS = 512
MIN_BLOCK_COLS = 1000            # a block's least share of the band: at
                                 # W 3,000 three blocks a pair beat 2 and 4-8
                                 # (time_sw.py --layouts on an H100)
CHUNK_ROWS = 64  # rows whose cell rule sw_scan_plain gathers at once
CHECK_EVERY = 32  # traceback_plain's steps between reads of the lanes' state


def sw_scan_plain(probes: torch.Tensor, targets: torch.Tensor,
                  plens: torch.Tensor, tlens: torch.Tensor,
                  diag0: torch.Tensor, *, W: int, match: int, mismatch: int,
                  gap_open: int, gap_ext: int, traceback: bool = True):
    """Plain PyTorch version of the scan kernel; its spec is `_sw_scan` of
    kit4b_tpu/pacbio/sswd.py. Returns (best, bi, bk) as [B] int32 and the
    [Lp, B, W] uint8 pointer bytes, or None without `traceback`.

    One row at a time, in chunks of CHUNK_ROWS rows: a chunk's target codes,
    cell rule and substitution scores are gathered at once, and its
    pointer bytes are packed at once from the rows' flags. H and E ride
    [B, W + 1] buffers whose last column stays NEG (the up neighbour past
    the band), and X rides one whose first column stays NEG, so that F's
    exclusive prefix maximum is one `cummax`. Once every lane is past its
    probe (no cell can match) and a row leaves the carried H and E as it
    found them, every later row repeats that row exactly: the rest of the
    pointer array is that row's bytes and the best cell does not move, so
    the loop stops after the chunk that holds that row. A chunk reads its
    first row from a device scalar and writes only into buffers made
    before it, so on a CUDA device the chunks after the first replay as
    one captured CUDA graph (`_replayed`), with one read of the host a
    chunk."""
    B, Lp = probes.shape
    Lt = targets.shape[1]
    dev = probes.device
    i32 = dict(dtype=torch.int32, device=dev)
    k = torch.arange(W, **i32)
    xoff = gap_open - (k + 1) * gap_ext       # X = H0 + xoff
    foff = k * gap_ext                         # F = Mx + foff
    base = diag0[:, None, None] + k[None, None, :] - W // 2
    score = (torch.tensor(match, **i32), torch.tensor(mismatch, **i32))
    neg = torch.tensor(NEG, **i32)
    Hb = torch.zeros((B, W + 1), **i32)        # H, then NEG
    Hb[:, W] = NEG
    Eb = torch.full((B, W + 1), NEG, **i32)    # E, then NEG
    Xb = torch.full((B, W + 1), NEG, **i32)    # NEG, then X
    H, Hup, Eup = Hb[:, :W], Hb[:, 1:], Eb[:, 1:]
    X, Xx = Xb[:, 1:], Xb[:, :W]
    best = torch.zeros(B, **i32)
    bi = torch.zeros(B, **i32)
    bk = torch.zeros(B, **i32)
    ptrs = torch.empty((Lp, B, W), dtype=torch.uint8, device=dev) \
        if traceback else None
    R = min(CHUNK_ROWS, Lp)
    if traceback:
        dirb = torch.empty((R, B, W), dtype=torch.uint8, device=dev)
        usedf, eext, fext = (torch.empty((R, B, W), dtype=torch.bool,
                                         device=dev) for _ in range(3))
        packed = torch.empty((R, B, W), dtype=torch.uint8, device=dev)
    last_probe_row = torch.tensor(int(plens.max()) if B else 0, **i32)
    first = torch.zeros((), **i32)             # the chunk's first row
    steady_at = torch.full((), -1, **i32)      # the first steady row
    row_of = torch.arange(R, **i32)

    def chunk(n: int) -> None:
        """Rows [first, first + n): the carried state, and the pointer
        bytes into `packed`."""
        rows = first + row_of[:n]
        cols = base + rows[None, :, None]                      # [B, n, W]
        tb = torch.gather(targets, 1, cols.clamp(0, Lt - 1).view(B, -1)
                          .long()).view(B, n, W)
        pb = torch.gather(probes, 1, rows.clamp(max=Lp - 1).long()[None]
                          .expand(B, n))[:, :, None]
        okp = (rows[None, :, None] < plens[:, None, None]) & (pb < 4) \
            & (cols >= 0) & (cols < tlens[:, None, None]) & (tb < 4)
        subs = torch.where(okp, torch.where(pb == tb, *score), neg)
        for r in range(n):
            i = rows[r]
            e_open = Hup + gap_open
            e_ext = Eup + gap_ext
            E = torch.maximum(e_open, e_ext)
            diag = H + subs[:, r]
            H0 = torch.maximum(diag, E).clamp_(min=0)
            torch.add(H0, xoff, out=X)
            Mx = torch.cummax(Xb, 1).values[:, :W]
            F = Mx + foff
            Hf = torch.maximum(H0, F)
            rk = Hf.argmax(1).to(torch.int32)
            rb = Hf.amax(1)
            improve = rb > best
            torch.maximum(best, rb, out=best)
            bi.copy_(torch.where(improve, i, bi))
            bk.copy_(torch.where(improve, rk, bk))
            if traceback:
                dirb[r] = torch.where(H0 == 0, 0,
                                      torch.where(H0 == diag, 1, 2))
                torch.gt(F, H0, out=usedf[r])
                torch.ge(e_ext, e_open, out=eext[r])
                torch.gt(Mx, Xx, out=fext[r])
            steady = (steady_at < 0) & (i >= last_probe_row) \
                & (Hf == H).all() & (E == Eb[:, :W]).all()
            steady_at.copy_(torch.where(steady, i, steady_at))
            H.copy_(Hf)
            Eb[:, :W] = E
        if traceback:
            torch.bitwise_or(dirb[:n] | (usedf[:n].to(torch.uint8) << 2)
                             | (eext[:n].to(torch.uint8) << 3),
                             fext[:n].to(torch.uint8) << 4, out=packed[:n])

    full = _replayed(lambda: chunk(R), dev if B else torch.device("cpu"))
    for i0 in range(0, Lp, R):
        n = min(R, Lp - i0)
        first.fill_(i0)
        if n == R:
            full()
        else:
            chunk(n)
        at = int(steady_at)
        done = n if at < 0 else at - i0 + 1
        if traceback:
            ptrs[i0:i0 + done] = packed[:done]
            if at >= 0:
                ptrs[i0 + done:] = ptrs[i0 + done - 1]
        if at >= 0:
            break
    return best, bi, bk, ptrs


def _replayed(step, dev: torch.device):
    """`step` as a callable that runs it: on a CUDA device the first call
    runs it on a side stream and captures it as a CUDA graph, and later
    calls replay the graph; elsewhere every call runs it. `step` must read
    its inputs from tensors and write only into tensors made before it."""
    if dev.type != "cuda":
        return step
    graph = None

    def call():
        nonlocal graph
        if graph is not None:
            graph.replay()
            return
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
    return call

def _walk_tables(dev: torch.device):
    """(next state, op, stop) of one step of the traceback for each index
    state * 32 + pointer byte: `_traceback_dev`'s state machine (0 H, 1 H0,
    2 E, 3 F; ops 1 M, 2 D, 3 I) with its steps that neither emit nor move
    (state H, and H0 whose byte says up) folded into the step after them,
    which reads the same byte."""
    state = torch.arange(4, device=dev).repeat_interleave(32)
    byte = torch.arange(32, device=dev).repeat(4)
    d = byte & 3
    state = torch.where(state == 0, torch.where((byte & 4) != 0, 3, 1),
                        state)
    state = torch.where((state == 1) & (d == 2), 2, state)
    nxt = torch.where(state == 1, 0,
                      torch.where(state == 2,
                                  torch.where((byte & 8) != 0, 2, 0),
                                  torch.where((byte & 16) != 0, 3, 1)))
    op = torch.where(state == 1, torch.where(d == 1, 1, 0),
                     torch.where(state == 2, 2, 3))
    return nxt, op, (state == 1) & (d == 0)


def traceback_plain(ptrs: torch.Tensor, probes: torch.Tensor,
                    targets: torch.Tensor, best: torch.Tensor,
                    bi: torch.Tensor, bk: torch.Tensor, diag0: torch.Tensor,
                    *, W: int, L_OPS: int):
    """Plain PyTorch version of the traceback kernel; its spec is
    `_traceback_dev` of kit4b_tpu/pacbio/sswd.py. Every lane steps in
    lockstep through `_walk_tables`, a lane that has stopped keeps its
    state, and the host reads whether any lane still walks every
    CHECK_EVERY steps (on a CUDA device those steps replay as one captured
    CUDA graph after their first run, `_replayed`). Returns ops ([B,
    L_OPS] int8), n, ps, ts, nm, nmm ([B] int32)."""
    Lp, B, _ = ptrs.shape
    Lq, Lt = probes.shape[1], targets.shape[1]
    dev = ptrs.device
    nxt, opc, stops = _walk_tables(dev)
    lanes = torch.arange(B, device=dev)
    d0 = diag0.long() - W // 2
    i = bi.long()
    c = d0 + i + bk.long()
    state = torch.zeros(B, dtype=torch.long, device=dev)
    n, nm, nmm = (torch.zeros(B, dtype=torch.long, device=dev)
                  for _ in range(3))
    ops = torch.zeros((B, L_OPS), dtype=torch.int8, device=dev)
    stop = best <= 0

    def walking():
        k = c - i - d0
        return ~stop & (i >= 0) & (c >= 0) & (k >= 0) & (k < W) \
            & (n < L_OPS)

    def steps():
        for _ in range(CHECK_EVERY):
            act = walking()
            k = (c - i - d0).clamp(0, W - 1)
            byte = ptrs[i.clamp(0, Lp - 1), lanes, k]
            t = state * 32 + byte
            op = opc[t]
            emit = act & (op > 0)
            m_op = emit & (op == 1)
            match = probes[lanes, i.clamp(0, Lq - 1)] \
                == targets[lanes, c.clamp(0, Lt - 1)]
            nm.add_(m_op & match)
            nmm.add_(m_op & ~match)
            slot = n.clamp(max=L_OPS - 1)[:, None]
            ops.scatter_(1, slot, torch.where(
                emit[:, None], op.to(torch.int8)[:, None],
                ops.gather(1, slot)))
            n.add_(emit)
            i.sub_((emit & (op != 3)).long())
            c.sub_((emit & (op != 2)).long())
            state.copy_(torch.where(act, nxt[t], state))
            stop.logical_or_(act & stops[t])
    run = _replayed(steps, dev if B else torch.device("cpu"))
    while bool(walking().any()):
        run()
    i32 = torch.int32
    return (ops, n.to(i32), (i + 1).to(i32), (c + 1).to(i32), nm.to(i32),
            nmm.to(i32))

def _block_threads(W: int, P: int, C: int) -> int:
    """Threads a block of the scan: the pair's warps of 32 x C columns
    spread over P blocks."""
    warps = -(-W // (32 * C))
    return -(-warps // P) * 32


def scan_layouts(W: int) -> list[tuple[int, int]]:
    """Every (P, C) the scan kernel takes for band W: at most 32 warps a
    pair and 512 threads a block."""
    return [(P, C) for P in CLUSTER_SIZES for C in THREAD_COLS
            if _block_threads(W, P, C) <= MAX_BLOCK_THREADS
            and P * _block_threads(W, P, C) // 32 <= MAX_WARPS]


def scan_layout(B: int, W: int, sms: int = 132) -> tuple[int, int]:
    """(P, C) of the scan for B pairs in a band of W on a card of `sms`
    SMs: the largest cluster whose B x P blocks fit on the SMs and leave
    each block MIN_BLOCK_COLS columns (else the smallest that takes W),
    then the fewest columns a thread that fit."""
    fits = scan_layouts(W)
    sizes = sorted({P for P, _ in fits})
    fill = [P for P in sizes if B * P <= sms and W >= P * MIN_BLOCK_COLS]
    P = max(fill) if fill else sizes[0]
    return P, min(C for p, C in fits if p == P)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sw")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sw_scan_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                   i, i, p, p, p, p, p]
    lib.sw_scan_launch.restype = i
    lib.sw_scan_clusters.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.sw_scan_clusters.restype = i
    lib.sw_cluster_probe.argtypes = [i, i, i, p, p]
    lib.sw_cluster_probe.restype = i
    lib.sw_traceback_launch.argtypes = [i, p, p, p, p, p, p, p, i, i, i, i,
                                        i, i, p, p, p, p, p, p, p]
    lib.sw_traceback_launch.restype = i
    return lib


def _check(fn: str, dev: torch.device, **tensors) -> None:
    """Raises unless every tensor lies on `dev`, is contiguous and has the
    kernel's dtype: uint8 sequences and pointer bytes, int32 the rest."""
    for name, t in tensors.items():
        want = torch.uint8 if name in ("probes", "targets", "ptrs") \
            else torch.int32
        if t.device != dev:
            raise ValueError(f"{fn}: {name} on {t.device}, not {dev}")
        if t.dtype != want:
            raise ValueError(f"{fn}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def sw_scan(probes: torch.Tensor, targets: torch.Tensor,
            plens: torch.Tensor, tlens: torch.Tensor, diag0: torch.Tensor,
            *, W: int, match: int, mismatch: int, gap_open: int,
            gap_ext: int, traceback: bool = True,
            layout: tuple[int, int] | None = None):
    """(best, bi, bk, pointer bytes or None): the CUDA kernel for CUDA
    tensors, `sw_scan_plain` for CPU tensors. `layout` (P, C) overrides
    `scan_layout`'s choice on the card. Each kernel launch adds one to
    `sw_scan.launches`."""
    kw = dict(W=W, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_ext=gap_ext, traceback=traceback)
    if probes.device.type == "cpu":
        return sw_scan_plain(probes, targets, plens, tlens, diag0, **kw)
    dev = probes.device
    if dev.type != "cuda":
        raise ValueError(f"sw_scan: tensors on {dev}; the kernel runs on "
                         "CUDA")
    _check("sw_scan", dev, probes=probes, targets=targets, plens=plens,
           tlens=tlens, diag0=diag0)
    if probes.dim() != 2 or targets.dim() != 2:
        raise ValueError("sw_scan: probes and targets must be [B, L]")
    B, Lp = probes.shape
    Lt = targets.shape[1]
    if targets.shape[0] != B or any(t.shape != (B,) for t in
                                    (plens, tlens, diag0)):
        raise ValueError(f"sw_scan: probes {tuple(probes.shape)}, targets "
                         f"{tuple(targets.shape)} and the [B] vectors "
                         "disagree on B")
    if not 1 <= W <= MAX_W:
        raise ValueError(f"sw_scan: band {W} outside the kernel's [1, "
                         f"{MAX_W}]")
    if Lt < 1:
        raise ValueError("sw_scan: targets must have a column")
    best, bi, bk = (torch.empty(B, dtype=torch.int32, device=dev)
                    for _ in range(3))
    ptrs = torch.empty((Lp, B, W), dtype=torch.uint8, device=dev) \
        if traceback else None
    if B == 0 or Lp == 0:
        for t in (best, bi, bk):
            t.zero_()
        return best, bi, bk, ptrs
    P, C = layout or scan_layout(B, W, _sms(dev))
    if (P, C) not in scan_layouts(W):
        raise ValueError(f"sw_scan: layout {(P, C)} does not fit band {W}")
    d = _device_index(dev)
    err = _lib().sw_scan_launch(
        d, probes.data_ptr(), targets.data_ptr(), plens.data_ptr(),
        tlens.data_ptr(), diag0.data_ptr(), B, Lp, Lt, W, match, mismatch,
        gap_open, gap_ext, P, C, ptrs.data_ptr() if traceback else None,
        best.data_ptr(), bi.data_ptr(), bk.data_ptr(),
        torch.cuda.current_stream(d).cuda_stream)
    if err:
        raise RuntimeError(f"sw_scan kernel launch failed: CUDA error {err}")
    sw_scan.launches += 1
    return best, bi, bk, ptrs


sw_scan.launches = 0


def scan_clusters(dev: torch.device, B: int, W: int,
                  layout: tuple[int, int]) -> int:
    """How many clusters of the scan at `layout` the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    n = ctypes.c_int(0)
    err = _lib().sw_scan_clusters(_device_index(dev), B, W, *layout,
                                  ctypes.byref(n))
    if err:
        raise RuntimeError(f"sw_scan_clusters failed: CUDA error {err}")
    return n.value


def cluster_costs(dev: torch.device, P: int, iters: int = 20_000):
    """(ns of a cluster barrier, of a DSMEM load, of a load of the block's
    own shared memory) on one cluster of P blocks: `iters` of each, the
    loads dependent, each run timed on the card's clock."""
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    d = _device_index(dev)
    err = _lib().sw_cluster_probe(d, P, iters, out.data_ptr(),
                                  torch.cuda.current_stream(d).cuda_stream)
    if err:
        raise RuntimeError(f"sw_cluster_probe failed: CUDA error {err}")
    ns = out.cpu().tolist()
    return ns[0] / iters, ns[1] / iters, ns[2] / iters


def sw_traceback(ptrs: torch.Tensor, probes: torch.Tensor,
                 targets: torch.Tensor, best: torch.Tensor, bi: torch.Tensor,
                 bk: torch.Tensor, diag0: torch.Tensor, *, W: int,
                 L_OPS: int):
    """(ops, n, ps, ts, nm, nmm): the CUDA kernel for CUDA tensors,
    `traceback_plain` for CPU tensors. Each kernel launch adds one to
    `sw_traceback.launches`."""
    if ptrs.device.type == "cpu":
        return traceback_plain(ptrs, probes, targets, best, bi, bk, diag0,
                               W=W, L_OPS=L_OPS)
    dev = ptrs.device
    if dev.type != "cuda":
        raise ValueError(f"sw_traceback: tensors on {dev}; the kernel runs "
                         "on CUDA")
    _check("sw_traceback", dev, ptrs=ptrs, probes=probes, targets=targets,
           best=best, bi=bi, bk=bk, diag0=diag0)
    if ptrs.dim() != 3 or ptrs.shape[2] != W:
        raise ValueError(f"sw_traceback: pointer bytes {tuple(ptrs.shape)} "
                         f"are not [Lp, B, {W}]")
    Lp, B, _ = ptrs.shape
    if probes.dim() != 2 or targets.dim() != 2 or probes.shape[0] != B \
            or targets.shape[0] != B or any(
                t.shape != (B,) for t in (best, bi, bk, diag0)):
        raise ValueError("sw_traceback: inputs disagree on B")
    if min(Lp, probes.shape[1], targets.shape[1], L_OPS) < 1:
        raise ValueError("sw_traceback: empty pointer rows, sequences or "
                         "ops")
    if ptrs.data_ptr() % 4:
        raise ValueError("sw_traceback: pointer bytes must start on a "
                         "4-byte boundary")
    ops = torch.zeros((B, L_OPS), dtype=torch.int8, device=dev)
    n, ps, ts, nm, nmm = (torch.empty(B, dtype=torch.int32, device=dev)
                          for _ in range(5))
    if B == 0:
        return ops, n, ps, ts, nm, nmm
    d = _device_index(dev)
    err = _lib().sw_traceback_launch(
        d, ptrs.data_ptr(), probes.data_ptr(), targets.data_ptr(),
        best.data_ptr(), bi.data_ptr(), bk.data_ptr(), diag0.data_ptr(), B,
        Lp, probes.shape[1], targets.shape[1], W, L_OPS, ops.data_ptr(),
        n.data_ptr(), ps.data_ptr(), ts.data_ptr(), nm.data_ptr(),
        nmm.data_ptr(), torch.cuda.current_stream(d).cuda_stream)
    if err:
        raise RuntimeError(f"sw_traceback kernel launch failed: CUDA error "
                           f"{err}")
    sw_traceback.launches += 1
    return ops, n, ps, ts, nm, nmm


sw_traceback.launches = 0

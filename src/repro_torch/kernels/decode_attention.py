"""Launch wrapper of the hand-written CUDA split-K decode-attention kernel
(``csrc/decode_attention.cu``), the decode attention of the serving path.

Only CUDA tensors are taken; :func:`repro_torch.kernels.ops.decode_attention`
sends CPU tensors to the plain version instead.  The cache is read in place
in the serving pool's grouped layout ``[B, S, KV, D]`` (query head ``h``
reads KV head ``h // (H // KV)``), and every row has its own valid length,
because the continuous batcher's slots sit at different positions.  The
TPU kernel's ``[BH, D]`` / ``[BH, S, D]`` form is the case ``H = KV = 1``.
One call is one kernel launch: the splits and their in-order merge.
With ``lse`` (an fp32 [B, H] buffer) the launch also writes each row's
base-2 log-sum-exp of its scaled scores from that merge's final max and
denominator (``-1e30`` for a row with no valid key): what two slices of a
cache need to be merged into the whole (``models.layers``' kv_seq-sharded
decode).  ``softcap`` > 0 caps each scaled score at ``c tanh(s / c)``
before the softmax (the JAX layers' ``decode_attention`` rule); the lse is
then the capped scores', so the merge of two slices is unchanged.
:func:`plan` sizes the splits from the shape (the lengths stay on the
device); the partials and the merge counters are scratch kept per device
and stream across calls, so calls in flight on different streams never
share them.  A call may be captured into a CUDA graph only inside
:func:`graph_scratch`, which gives it scratch of the graph's own: allocated
in the capture (the counters' zeroing is captured too, so it runs at the
start of every replay), held as long as the graph, and shared with no
other graph or stream.  The kernel leaves the counters at zero after every
launch.

The kernel has two routes, and :func:`plan` picks one from the shape
(``DecodePlan.route``):

- ``"hmma"``, bf16 with 2 to 16 query heads a KV head (10 at D = 256): the
  group's rows, padded to 16, share each K/V tile in one warp matrix
  product on the tensor cores (``mma.sync`` m16n8k16, HMMA): Q K^T with
  fp32 sums, the online softmax on the score fragments, p rounded to bf16
  and repacked as the A fragment of P V.  K and V come from each warp's
  cp.async ring by ``ldmatrix``, its 16-byte chunks XOR-swizzled
  (:func:`ring_chunk`).
- ``"lanes"``, fp32, bf16 at group 1 and bf16 groups past 16 (D <= 64):
  the CUDA-core kernel.  A lane owns one 16-byte chunk of a query row; a
  row takes :func:`lanes_per_row` lanes, the chunk count rounded up to a
  power of two (D = 80 is 10 chunks in bf16 and 20 in fp32, so 16 and 32
  lanes), and the lanes past the row's chunks hold zeros.  A row of more
  than 32 chunks (fp32 at D = 256: 64) takes the whole warp,
  :func:`chunks_per_lane` chunks a lane.  The group's padded width, (H /
  KV) times the padded D, is at most 2048, and at D = 256 the 10 query
  heads over one KV head of recurrentgemma, in 10 row passes
  (:func:`max_group`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from contextlib import contextmanager
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import check_masks

# kernel launches since the last reset (repro_torch.kernels.ops)
launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MAX_GROUP_WIDTH = 2048          # (H // KV) * padded D the block can hold
GROUP_256 = 10                  # H // KV at D = 256: its own 10-pass kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# keys a split is a multiple of: one warp tile (half of one at D = 256,
# :func:`warp_tile`)
KEY_TILE = {torch.float32: 8, torch.bfloat16: 16}
SMS = 132                       # H100 SXM
THREADS = 256                   # a block's threads (8 warps)
MERGE_LOADS = 160               # partials a merging thread loads, at most
# the tensor-core route: the most query heads a KV head (one 16-row tile;
# 10 at D = 256, held to the library's at load)
HMMA_ROWS = 16
HMMA_GROUP_256 = 10
# the tensor-core route's grid: 0.75 waves of the SMs over the whole cache,
# splits of at least HMMA_MIN_CHUNK keys (scripts/decode_routes.py: a
# block's fixed costs, its first loads, its partial and the merge, outweigh
# its keys, so fewer and longer splits win; PERF.md rows 4-4i)
HMMA_WAVES = 0.75
HMMA_MIN_CHUNK = 256
ROUTES = {"lanes": 0, "hmma": 1}
# the tensor-core route merges its splits in a tree: the last of each
# MERGE_FAN consecutive live splits to arrive merges them, the last of
# those merges the groups (a merge counter each, beside the top one)
MERGE_FAN = 16


def lanes_per_row(d: int, dtype: torch.dtype) -> int:
    """Lanes a query row takes: its 16-byte chunks rounded up to a power
    of two, at most the warp's 32, so the xor-shuffle sum over a row's
    lanes stays in the row."""
    chunks = d * dtype.itemsize // 16
    return min(32, 1 << (chunks - 1).bit_length())


def chunks_per_lane(d: int, dtype: torch.dtype) -> int:
    """16-byte chunks of a row each lane holds: 1, or 2 where a row has
    more chunks than a warp has lanes (fp32 at D = 256); lane ``c`` holds
    chunks ``c`` and ``c + 32``."""
    return -(-(d * dtype.itemsize // 16) // lanes_per_row(d, dtype))


def warp_tile(d: int, dtype: torch.dtype) -> int:
    """Keys a warp takes per stage of its ring, on either route: the key
    tile, halved at D = 256 so that the 8 warps' 3-stage K/V rings stay
    within 192 KB."""
    return KEY_TILE[dtype] // 2 if d > 128 else KEY_TILE[dtype]


def max_group(d: int, dtype: torch.dtype) -> int:
    """The most query heads a KV head (H // KV) the kernel takes at ``d``:
    the group's padded width, rep * lanes * chunks a lane * 16 bytes'
    elements, <= 2048; at D = 256, the 10 of its own instantiation."""
    if d == 256:
        return GROUP_256
    return MAX_GROUP_WIDTH // (lanes_per_row(d, dtype)
                               * chunks_per_lane(d, dtype)
                               * 16 // dtype.itemsize)


def hmma_group(d: int) -> int:
    """The most query heads a KV head the tensor-core route takes at
    ``d``: one 16-row tile, 10 at D = 256."""
    return HMMA_GROUP_256 if d > 128 else HMMA_ROWS


def route(h: int, kvh: int, d: int, dtype: torch.dtype) -> str:
    """The kernel route of a call: ``"hmma"`` for bf16 groups of 2 to
    :func:`hmma_group` query heads a KV head, ``"lanes"`` for the rest."""
    rep = h // max(kvh, 1)
    if dtype == torch.bfloat16 and 2 <= rep <= hmma_group(d):
        return "hmma"
    return "lanes"


def ring_chunk(r: int, c: int, d: int) -> int:
    """Where the tensor-core route puts 16-byte chunk ``c`` of row ``r`` of
    a [rows, D] bf16 tile in shared memory, in chunks (``swz`` in
    ``csrc/decode_attention.cu``): c's low three bits XOR the row's where
    its 8-chunk group is whole (D = 80's last two chunks stay), and at 2 or
    4 chunks a row (D = 16, 32) XOR the row's group of 8 / CPR rows."""
    cpr = d // 8
    if cpr < 8:
        return r * cpr + (c ^ ((r // (8 // cpr)) & (cpr - 1)))
    return r * cpr + (c ^ (r & 7) if c < cpr // 8 * 8 else c)


class DecodePlan(NamedTuple):
    chunk: int           # keys per split, a multiple of the key tile
    n_splits: int        # ceil(s_len / chunk): the grid is n_splits x B*KV
    route: str           # a key of ROUTES: the kernel that runs


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, kvh: int, s_len: int, d: int,
         dtype: torch.dtype) -> DecodePlan:
    """Splits of q [B, H, D] over a [B, S, KV, D] cache of ``dtype``: its
    B * KV rows of ``s_len`` keys, and the route (:func:`route`).  The
    lengths live on the device, so the grid is sized for 2.5 waves of the
    132 SMs over the whole cache: with the slots about half full, as in a
    serving pool, the live blocks then fill a little over one wave ([4,
    2112, 8, 64] at lengths 1/300/1000/2112: chunk 192, 160 of 352 blocks
    live).  Splits past a row's length return at once.  The splits are
    capped on the CUDA-core route so that each thread of the block that
    merges them loads at most ``MERGE_LOADS`` of the group's (H / KV) * D
    partial sums: its merge runs each output's splits in turn, so its
    chain grows with splits times width (recurrentgemma's [4, 2048, 1,
    256] ring at 10 query heads: 16 splits, where 2.5 waves ask for 83).
    The tensor-core route's merge loads the splits of all of a thread's
    outputs together, and past MERGE_FAN of them merges in a tree, so its
    chain grows with the splits alone, and it takes no cap.  The tensor-core
    route sizes its grid for 0.75 waves with splits of at least 256 keys
    (:func:`hmma_splits`): its blocks are short, and their fixed costs set
    the pace (scripts/decode_routes.py on an H100: the [4, 2112, 8, 128]
    pool at 12 query heads a KV head 0.0174 ms device at 0.75 waves, 0.0222
    at 2.5; recurrentgemma's ring 0.0172 at 8 splits, 0.0292 at 64).

    The route's group threshold is 2: on the CUDA-core kernel, groups of 2
    to 4 at D = 64 take one row pass and ran 0.0101-0.0103 ms device
    against the tensor-core route's 0.0098-0.0101 at the main pool (NVIDIA
    H100 80GB HBM3, 700.00 W; PERF.md, PR 31)."""
    way = route(h, kvh, d, dtype)
    if way == "hmma":
        return DecodePlan(*hmma_splits(b * kvh, s_len, h // kvh * d), way)
    return DecodePlan(*splits(b * kvh, s_len, h // kvh * d, KEY_TILE[dtype],
                              MERGE_LOADS), way)


def hmma_splits(rows: int, s_len: int, width: int,
                waves: float = HMMA_WAVES) -> Tuple[int, int]:
    """(chunk, n_splits) of the tensor-core route: ``waves`` waves of the
    SMs over the whole cache, at least HMMA_MIN_CHUNK keys a split, no cap
    on the splits (:func:`splits`)."""
    return splits(rows, s_len, width, KEY_TILE[torch.bfloat16], None,
                  waves, HMMA_MIN_CHUNK)


def splits(rows: int, s_len: int, width: int, key_tile: int,
           loads: Optional[int], waves: float = 2.5,
           min_chunk: int = 1) -> Tuple[int, int]:
    """(chunk, n_splits) of :func:`plan`: ``rows`` (slot, KV head) rows of
    ``s_len`` keys for ``waves`` waves of the SMs, whole ``key_tile``s a
    split and at least ``min_chunk`` keys, the splits capped (unless
    ``loads`` is None) at ``loads`` partials a merging thread over the
    group's ``width`` = (H / KV) * D partial sums."""
    want = max(1, math.ceil(waves * SMS / max(rows, 1)))
    if loads is not None:
        want = min(want, max(1, loads * THREADS // max(1, width)))
    per = max(-(-max(s_len, 1) // want), min_chunk)
    chunk = key_tile * -(-per // key_tile)
    return chunk, max(1, -(-s_len // chunk))


def block_smem(p: DecodePlan, rep: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the launch: the warps' 3-stage
    K/V rings, which the warp merge (an (m, l, sums) row a warp and query
    row) reuses; on the tensor-core route also the 16-row Q tile, and the
    split merge's weights (a float a query row and split) in the rings."""
    ring = 8 * 3 * 2 * warp_tile(d, dtype) * d * dtype.itemsize
    if p.route == "lanes":
        return max(ring, 8 * rep * (d + 2) * 4)
    # the tensor-core route pads the warp merge's rows by 8 floats and
    # keeps each warp's weights and each row's max and denominator beside
    most = max(MERGE_FAN, -(-p.n_splits // MERGE_FAN))
    return HMMA_ROWS * d * 2 + max(ring, 4 * (8 * rep * (d + 11) + 2 * rep),
                                   4 * (2 * rep * most + 2 * rep))


def counters(b: int, kvh: int, n_splits: int) -> int:
    """Merge counters a launch uses: one a (slot, KV head), and one for
    each MERGE_FAN splits of it (the tensor-core route's first level)."""
    return b * kvh * (1 + -(-n_splits // MERGE_FAN))


def valid_rows(cache_len, b: int, s_len: int) -> int:
    """Cache rows the lengths make valid, summed over the ``b`` slots:
    ``cache_len`` an int (every slot), or a list or tensor of 1 or ``b``
    host-readable lengths, each clamped to the cache's ``s_len``."""
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.reshape(-1).tolist()
    if isinstance(cache_len, int):
        cache_len = [cache_len]
    lens = [min(max(int(n), 0), s_len) for n in cache_len]
    return sum(lens) * (b if len(lens) == 1 else 1)


def work(b: int, h: int, kvh: int, d: int, valid: int, itemsize: int = 2,
         lse: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of one launch over ``valid`` cache rows in all
    (:func:`valid_rows`): 4 FLOP per query head, head dim and valid key
    (q k and p v), the valid rows of K and V read once, q read and the
    output written once (and, with ``lse``, the fp32 log-sum-exps).  The
    bound in PERF.md and the modeled cost both take it."""
    nbytes = itemsize * (2 * valid * kvh * d + 2 * b * h * d)
    return (4.0 * h * d * valid, float(nbytes + (4 * b * h if lse else 0)))


def live_blocks(p: DecodePlan, lens, kvh: int) -> int:
    """Blocks that do work for these per-slot lengths (the rest return at
    once)."""
    return kvh * sum(-(-min(int(n), p.chunk * p.n_splits) // p.chunk)
                     for n in lens)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.repro_decode_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.repro_decode_attention.restype = ctypes.c_int
    for fn in (lib.repro_decode_attention_key_tile,
               lib.repro_decode_attention_mma_group):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    for dtype, code in _DTYPE_CODES.items():
        if lib.repro_decode_attention_key_tile(code) != KEY_TILE[dtype]:
            raise RuntimeError("csrc/decode_attention.cu's key tile differs "
                               "from KEY_TILE")
    for d in HEAD_DIMS:
        if lib.repro_decode_attention_mma_group(d) != hmma_group(d):
            raise RuntimeError(f"csrc/decode_attention.cu's tensor-core "
                               f"group at D={d} differs from hmma_group")
    return lib


# per (device, stream): (fp32 partials, int32 merge counters kept at zero);
# a kernel on one stream only ever meets its own stream's scratch
_SCRATCH: dict = {}
# while a CUDA graph captures: that graph's own scratch, per device
_graph_store = None


@contextmanager
def graph_scratch(store: dict):
    """Route the scratch of the calls in the block to ``store``, a dict that
    the graph being captured holds (``ops.CountedGraph``)."""
    global _graph_store
    outer, _graph_store = _graph_store, store
    try:
        yield
    finally:
        _graph_store = outer


def scratch_key(dev, stream: int, graph: Optional[dict] = None):
    """The store and key of the scratch a launch on ``stream`` uses: its
    own (device, stream) entry, or a graph's own store while one captures
    (``graph``), so no two streams and no two graphs share one."""
    return (_SCRATCH, (dev, stream)) if graph is None else (graph, dev)


def _scratch(dev: torch.device, stream: int, floats: int, groups: int):
    if torch.cuda.is_current_stream_capturing() and _graph_store is None:
        raise RuntimeError("decode attention is captured into a CUDA graph "
                           "only inside graph_scratch (ops.CountedGraph), "
                           "so that the graph holds its own scratch")
    store, key = scratch_key(dev, stream, _graph_store)
    part, counters = store.get(key, (None, None))
    if part is None or part.numel() < floats or counters.numel() < groups:
        part = torch.empty((floats,), dtype=torch.float32, device=dev)
        counters = torch.zeros((groups,), dtype=torch.int32, device=dev)
        store[key] = (part, counters)
    return part, counters


def lens_tensor(cache_len, b: int, device: torch.device) -> torch.Tensor:
    """``cache_len`` (an int, or an int tensor of 1 or ``b`` entries) as a
    contiguous int32 [b] tensor on ``device``.  While a CUDA graph is
    being captured only a tensor already on ``device`` is taken: an int or
    a host tensor would be a host-to-device copy, which a capture forbids
    (and a replay would not repeat), so it raises."""
    if (isinstance(cache_len, torch.Tensor) and cache_len.dtype == torch.int32
            and cache_len.device == device and cache_len.shape == (b,)
            and cache_len.is_contiguous()):
        return cache_len            # the serving path's lengths, as they are
    if torch.cuda.is_current_stream_capturing() and not (
            isinstance(cache_len, torch.Tensor)
            and cache_len.device == device):
        raise RuntimeError(
            f"decode attention captured into a CUDA graph takes its lengths "
            f"as a tensor on {device}, not {type(cache_len).__name__} "
            f"{cache_len!r} from the host")
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return lens.reshape(-1).expand(b).contiguous()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     lse: Optional[torch.Tensor] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, D]; k/v_cache [B, S, KV, D]; ``cache_len`` int or int
    tensor [B] -> [B, H, D] in ``q.dtype``; a row of length 0 gets zeros.
    ``lse``, a contiguous fp32 [B, H] tensor on q's device, receives each
    row's base-2 log-sum-exp (``-1e30`` at length 0); ``softcap`` 0 is no
    cap."""
    global launches
    dev = q.device
    if dev.type != "cuda" or k_cache.device != dev or v_cache.device != dev:
        raise ValueError(f"CUDA decode attention needs q and the caches on "
                         f"one CUDA device, got {q.device}, {k_cache.device},"
                         f" {v_cache.device}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode attention takes q [B,H,D] and caches "
                         f"[B,S,KV,D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s_len, kvh, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not group over the cache "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS or h // kvh > max_group(d, q.dtype):
        raise ValueError(f"CUDA decode attention takes head dim D in "
                         f"{HEAD_DIMS} with H/KV <= {MAX_GROUP_WIDTH} over "
                         f"the padded D (<= {GROUP_256} at D = 256), got "
                         f"D={d}, H/KV={h // kvh}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"CUDA decode attention takes float32 or bfloat16 "
                        f"q/caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("CUDA decode attention takes contiguous q and "
                         "caches")
    if not all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache)):
        raise ValueError("CUDA decode attention needs 16-byte aligned q and "
                         "caches (16-byte cp.async copies)")
    if lse is not None and (lse.shape != (b, h) or lse.dtype != torch.float32
                            or lse.device != dev or not lse.is_contiguous()):
        raise ValueError(f"decode attention's lse is a contiguous float32 "
                         f"[{b}, {h}] tensor on {dev}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    check_masks(0, 0, softcap, "decode attention")
    lens = lens_tensor(cache_len, b, dev)
    out = torch.empty((b, h, d), dtype=q.dtype, device=dev)
    if b == 0 or h == 0:
        return out
    lib = _lib()
    p = plan(b, h, kvh, s_len, d, q.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, cnt = _scratch(dev, stream, b * h * p.n_splits * (d + 2),
                         counters(b, kvh, p.n_splits))
    with _build.on_device(dev):
        err = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part.data_ptr(),
            cnt.data_ptr(), b, h, kvh, s_len, d, p.chunk, p.n_splits,
            1.0 / math.sqrt(d), float(softcap), _DTYPE_CODES[q.dtype],
            ROUTES[p.route], stream)
    _build.check(lib, err, "decode_attention")
    launches += 1
    return out

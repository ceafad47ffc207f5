"""Static lint of the hand-written CUDA kernels' launch plans; the port of
``repro.analysis.kernel_lint``.

Each kernel's wrapper sizes its launch on the host (the ``plan`` functions
of ``repro_torch.kernels``, held to the compiled sources where they load)
and each kernel maps its block index to the tiles it reads and writes.
This pass restates those launches declaratively as :class:`KernelModel`
records — the grid, the block's threads and dynamic shared memory, and
for every operand the element range a block touches — built from the
``plan`` functions at a problem size, and checks them with integer
arithmetic over the whole grid (numpy over the block coordinates,
imported when a model is checked: importing the package pulls in neither
torch nor numpy):

  * **K001** coverage: the blocks write every output element exactly
    once (a grid dimension whose blocks merge into one tile, decode's
    split-K, is declared in ``merge_dims`` and counts once); a tile that
    runs past a ragged edge must be one the kernel masks
    (``OperandSpec.masked``).
  * **K002** bounds and launch limits: every block's reads and writes
    start inside their operands and end inside them or on a masked edge;
    grid x <= 2^31 - 1, grid y and z <= 65535, <= 1024 threads and <= 227
    KB (232448 bytes) of dynamic shared memory a block, as ``sm_90``
    allows.
  * **K003** aliasing: an output that shares its buffer with an input,
    or a scratch buffer that two streams (or two captured graphs) would
    share (decode's partials and merge counters,
    ``kernels.decode_attention.scratch_key``).

:func:`lint_kernels` checks every kernel at representative sizes (the
reference's, and its bf16 and fp32 routes); :func:`check_model` is the
generic engine the tests drive with deliberately broken models.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import ERROR, INFO, Finding

MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
MAX_THREADS = 1024
MAX_SMEM = 232448              # 227 KB: a block's opt-in shared memory
MAX_BLOCKS = 1 << 22           # blocks enumerated; a larger grid is sampled


@dataclass
class OperandSpec:
    """One operand as a block sees it: ``index_map(bx, by, bz)`` gives the
    first element of the block's range along each dim (numpy arrays of
    the block coordinates in, arrays or ints out) and ``block`` its extent;
    ``masked`` lists the dims whose ragged edge the kernel masks (reads
    past it are zero-filled or skipped, writes dropped)."""
    name: str
    dims: Tuple[int, ...]
    block: Tuple[int, ...]
    index_map: Callable
    masked: Tuple[int, ...] = ()
    buffer: str = ""            # the storage it lives in ("" = its name)


@dataclass
class ScratchSpec:
    """A scratch buffer kept across launches: ``key(stream, graph)``
    identifies the entry a launch on ``stream`` uses, inside the capture
    of the graph whose store is ``graph`` (a dict), or of none."""
    name: str
    key: Callable


@dataclass
class KernelModel:
    """The declarative launch of one kernel at one problem size."""
    name: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int
    inputs: List[OperandSpec]
    outputs: List[OperandSpec]
    merge_dims: Tuple[int, ...] = ()    # grid dims merged into one tile
    scratch: List[ScratchSpec] = field(default_factory=list)
    size_tag: str = ""


def _coords(grid: Tuple[int, int, int]):
    """Every block's (bx, by, bz), or a sample of the corners and edges of
    a grid past ``MAX_BLOCKS`` blocks."""
    import numpy as np
    n = int(np.prod(grid))
    if n <= MAX_BLOCKS:
        return [c.ravel() for c in np.indices(grid, dtype=np.int64)]
    axes = [np.unique(np.r_[0:min(g, 4), max(g - 4, 0):g]) for g in grid]
    return [c.ravel() for c in np.meshgrid(*axes, indexing="ij")]


def _starts(spec: OperandSpec, coords) -> list:
    import numpy as np
    got = spec.index_map(*coords)
    size = coords[0].shape
    return [np.broadcast_to(np.asarray(s, dtype=np.int64), size)
            for s in got]


def check_model(model: KernelModel) -> List[Finding]:
    """K001 / K002 / K003 over one KernelModel."""
    import numpy as np
    out: List[Finding] = []
    tag = f" [{model.size_tag}]" if model.size_tag else ""

    def add(rule_id, severity, message):
        out.append(Finding(rule_id, severity, message + tag,
                           plan_field=None, subject=model.name))

    gx, gy, gz = model.grid
    if min(model.grid) < 1:
        add("K002", ERROR, f"empty grid {model.grid}")
        return out
    if gx > MAX_GRID_X or gy > MAX_GRID_YZ or gz > MAX_GRID_YZ:
        add("K002", ERROR, f"grid {model.grid} exceeds sm_90's limits "
            f"(x <= {MAX_GRID_X}, y and z <= {MAX_GRID_YZ})")
    if not 1 <= model.threads <= MAX_THREADS:
        add("K002", ERROR, f"{model.threads} threads a block (1..."
            f"{MAX_THREADS})")
    if not 0 <= model.smem <= MAX_SMEM:
        add("K002", ERROR, f"{model.smem} bytes of dynamic shared memory "
            f"a block (at most {MAX_SMEM})")

    coords = _coords(model.grid)
    for spec in model.inputs + model.outputs:
        if len(spec.dims) != len(spec.block):
            add("K002", ERROR, f"{spec.name}: block rank {len(spec.block)} "
                f"!= operand rank {len(spec.dims)}")
            continue
        try:
            starts = _starts(spec, coords)
        except Exception as e:          # noqa: BLE001  (reported)
            add("K002", ERROR, f"{spec.name}: index map raised {e!r}")
            continue
        for d, (s, dim, blk) in enumerate(zip(starts, spec.dims,
                                              spec.block)):
            end = s + blk
            if (s < 0).any() and d not in spec.masked:
                add("K002", ERROR, f"{spec.name}: a block starts at "
                    f"{int(s.min())} on axis {d}, before the operand")
            if (s >= max(dim, 1)).any() and dim > 0:
                add("K002", ERROR, f"{spec.name}: a block starts at "
                    f"{int(s.max())} on axis {d}, past its {dim} elements")
            if (end > dim).any() and d not in spec.masked:
                add("K002", ERROR, f"{spec.name}: a block reaches element "
                    f"{int(end.max())} on axis {d} of {dim} and the kernel "
                    "does not mask that edge")

    if int(np.prod(model.grid)) <= MAX_BLOCKS:
        for spec in model.outputs:
            out.extend(_coverage(model, spec, coords, tag))

    names = {(s.buffer or s.name) for s in model.inputs}
    for spec in model.outputs:
        if (spec.buffer or spec.name) in names:
            add("K003", ERROR, f"output {spec.name} shares buffer "
                f"{spec.buffer or spec.name!r} with an input: blocks read "
                "what others have already written")
    graphs = ({}, {})                   # two graphs' stores, held alive
    for sc in model.scratch:
        if sc.key(1, None) == sc.key(2, None):
            add("K003", ERROR, f"scratch {sc.name} is shared by launches "
                "on different streams")
        if sc.key(1, graphs[0]) in (sc.key(1, None), sc.key(1, graphs[1])):
            add("K003", ERROR, f"scratch {sc.name} is shared by a captured "
                "graph with another graph or with its stream")
    return out


def _coverage(model: KernelModel, spec: OperandSpec, coords,
              tag: str) -> List[Finding]:
    """K001: each output tile written by exactly one block (merge dims
    collapsed), tiles aligned to the block, every tile of the output
    reached, ragged edges masked."""
    import numpy as np

    def err(message):
        return Finding("K001", ERROR, f"{spec.name}: {message}{tag}",
                       plan_field=None, subject=model.name)

    if len(spec.dims) != len(spec.block):
        return []
    keep = np.ones(coords[0].shape, dtype=bool)
    for d in model.merge_dims:
        keep &= coords[d] == 0          # one writer a merged tile
    starts = [s[keep] for s in _starts(spec, coords)]
    out = []
    tiles = []
    for d, (s, dim, blk) in enumerate(zip(starts, spec.dims, spec.block)):
        if blk <= 0:
            return [err(f"nonpositive block {blk} on axis {d}")]
        if (s % blk).any():
            return [err(f"tiles on axis {d} do not start on multiples of "
                        f"the block {blk}")]
        if dim % blk and d not in spec.masked:
            out.append(err(f"axis {d}: {dim} % block {blk} != 0 and the "
                           "kernel does not mask the ragged edge"))
        tiles.append(s // blk)
    want = [-(-dim // blk) for dim, blk in zip(spec.dims, spec.block)]
    flat = np.ravel_multi_index(
        [np.clip(t, 0, w - 1) for t, w in zip(tiles, want)], want)
    counts = np.bincount(flat, minlength=int(np.prod(want)))
    if (counts > 1).any():
        out.append(err(f"{int((counts > 1).sum())} tiles written by more "
                       "than one block (a grid dim revisits them and is no "
                       "declared merge)"))
    if (counts == 0).any():
        out.append(err(f"{int((counts == 0).sum())} of {counts.size} tiles "
                       "written by no block"))
    return out


# ---------------------------------------------------------------------------
# The kernels' models, from their plan functions
# ---------------------------------------------------------------------------

def matmul_model(m: int = 300, n: int = 200, k: int = 150,
                 dtype: str = "float32"
                 ) -> Tuple[List[KernelModel], List[Finding]]:
    """``csrc/matmul.cu``: fp32 blocks of 64 x 32 of C (``matmul.plan``:
    ``32 * warps`` threads, each warp's 3-stage ring of K slabs), block
    (x, y) owning rows ``[64 y, 64 y + 64)``; bf16 as ``matmul.bf16_plan``
    routes it: a one-dimensional grid, block x owning the tile
    ``matmul.tile_of`` gives it, its warpgroups and stages of K tiles in
    dynamic shared memory; every edge masked."""
    from repro_torch.kernels import matmul as mm
    if dtype == "float32":
        p = mm.plan(m, n, k)
        bm, bn = mm.BLOCK_M, mm.BLOCK_N
        threads = 32 * p.warps
        smem = p.warps * 3 * (bm * (mm.SLAB_K + 4) + mm.SLAB_K * bn) * 4
        grid, route = (-(-n // bn), -(-m // bm), 1), "fp32"

        def tile(x, y):
            return y, x
    else:
        p = mm.bf16_plan(m, n, k)
        bm, bn = p.tile.tile_m, p.tile.tile_n
        threads, smem, route = p.tile.threads, p.tile.smem, p.route
        grid = (p.blocks, 1, 1)

        def tile(x, y):
            return mm.tile_of(p, x)
    model = KernelModel(
        name=f"matmul.{dtype}", grid=grid, threads=threads, smem=smem,
        inputs=[OperandSpec("a", (m, k), (bm, k),
                            lambda x, y, z: (tile(x, y)[0] * bm, 0),
                            masked=(0,)),
                OperandSpec("b", (k, n), (k, bn),
                            lambda x, y, z: (0, tile(x, y)[1] * bn),
                            masked=(1,))],
        outputs=[OperandSpec("c", (m, n), (bm, bn),
                             lambda x, y, z: (tile(x, y)[0] * bm,
                                              tile(x, y)[1] * bn),
                             masked=(0, 1))],
        size_tag=f"{m}x{k}@{k}x{n} {route}")
    return [model], []


def tdfir_model(f: int = 4, n: int = 1000, k: int = 16, planes: int = 1
                ) -> Tuple[List[KernelModel], List[Finding]]:
    """``csrc/tdfir.cu`` (``tdfir.plan``): block (x, y) filters row y's
    outputs ``[tile x, tile x + tile)`` from the window ``x[n0 - K', n0 +
    tile)`` (left of 0 zero-filled) and the K' padded taps."""
    from repro_torch.kernels import tdfir as fir
    if k > fir.max_taps(planes):
        return [], [Finding(
            "K002", ERROR, f"tdfir: {k} taps past the {fir.max_taps(planes)} "
            "whose rows and windows fit shared memory — the wrapper refuses",
            subject="tdfir")]
    p = fir.plan(f, n, k)
    t, kp = p.tile, p.taps
    name = "tdfir" if planes == 1 else "tdfir_complex"
    ins = [OperandSpec(f"x{c}", (f, n), (1, t + kp),
                       lambda x, y, z: (y, x * t - kp), masked=(1,))
           for c in range(planes)]
    ins += [OperandSpec(f"h{c}", (f, k), (1, kp), lambda x, y, z: (y, 0),
                        masked=(1,)) for c in range(planes)]
    model = KernelModel(
        name=name, grid=(p.grid_n, p.grid_f, 1), threads=p.threads,
        smem=p.smem_bytes(planes), inputs=ins,
        outputs=[OperandSpec(f"y{c}", (f, n), (1, t),
                             lambda x, y, z: (y, x * t), masked=(1,))
                 for c in range(planes)],
        size_tag=f"f{f} n{n} k{k}")
    return [model], []


def _flash_operands(bh, sq, skv, d, kv_group, rows, row0, head):
    """q, k, v, o and lse of a flash block that takes head ``head`` and
    query rows from ``row0`` (functions of the block coordinates); it
    walks every key of its KV head."""
    n_kv = bh // kv_group
    return ([OperandSpec("q", (bh, sq, d), (1, rows, d),
                         lambda x, y, z: (head(x, y), row0(x, y), 0),
                         masked=(1,)),
             OperandSpec("k", (n_kv, skv, d), (1, skv, d),
                         lambda x, y, z: (head(x, y) // kv_group, 0, 0)),
             OperandSpec("v", (n_kv, skv, d), (1, skv, d),
                         lambda x, y, z: (head(x, y) // kv_group, 0, 0))],
            [OperandSpec("o", (bh, sq, d), (1, rows, d),
                         lambda x, y, z: (head(x, y), row0(x, y), 0),
                         masked=(1,)),
             OperandSpec("lse", (bh, sq), (1, rows),
                         lambda x, y, z: (head(x, y), row0(x, y)),
                         masked=(1,))])


def _head_dim_refused(name: str, d: int, dtype) -> List[Finding]:
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    return [Finding("K001", ERROR, f"{name}: head dim {d} ({dtype}) is none "
                    f"of the kernel's {HEAD_DIMS} — the wrapper refuses",
                    subject=name)]


def flash_attention_model(bh: int = 8, sq: int = 1024, skv: int = 1024,
                          d: int = 64, dtype: str = "bfloat16",
                          kv_group: int = 1
                          ) -> Tuple[List[KernelModel], List[Finding]]:
    """``csrc/flash_attention.cu`` (``flash_attention.plan``): bf16 block x
    takes head ``x % bh`` and the ``x // bh``-th query tile from the last;
    fp32 block (x, y) head y, query tile x."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    if d not in fa.HEAD_DIMS:
        return [], _head_dim_refused("flash_attention", d, dtype)
    p = fa.plan(bh, sq, d, dt)
    n_qt = -(-sq // p.rows)
    if p.route == "wgmma":
        def head(x, y):
            return x % bh

        def row0(x, y):
            return (n_qt - 1 - x // bh) * p.rows
    else:
        def head(x, y):
            return y

        def row0(x, y):
            return x * p.rows
    ins, outs = _flash_operands(bh, sq, skv, d, kv_group, p.rows, row0, head)
    return [KernelModel(
        name=f"flash_attention.{dtype}", grid=p.grid, threads=p.threads,
        smem=p.smem, inputs=ins, outputs=outs,
        size_tag=f"bh{bh} sq{sq} skv{skv} d{d}")], []


def flash_attention_bwd_model(bh: int = 8, sq: int = 1024, skv: int = 1024,
                              d: int = 64, dtype: str = "bfloat16",
                              kv_group: int = 1
                              ) -> Tuple[List[KernelModel], List[Finding]]:
    """``csrc/flash_attention_bwd.cu``'s three launches
    (``flash_attention_bwd.plan``): the row statistics (block (x, y): head
    y's 64-row tile x), dK/dV (one block a key tile of a KV head, over
    every query row of its group) and dQ (one block a query tile).  The
    tensor-core route's grids are 1-D (bf16: 128 keys or rows a block, 64
    at D = 256, where the block's two warpgroups split the head dim and
    share the tile), the CUDA cores' (fp32) 2-D.  At D = 256 a key tile's
    group may split over blocks (``flash_attention_bwd.heads_per_block``),
    modelled as grid dim y merged into one tile (the last block adds the
    partials, per-call scratch); otherwise a block writes only its own
    keys or rows."""
    import torch

    from repro_torch.kernels import flash_attention_bwd as fab
    dt = getattr(torch, dtype)
    if d not in fab.HEAD_DIMS:
        return [], _head_dim_refused("flash_attention_bwd", d, dtype)
    p = fab.plan(d, dt)
    n_kv = bh // kv_group
    n_st = -(-sq // fab.STAT_ROWS)
    tag = f"bh{bh} sq{sq} skv{skv} d{d}"
    prep = KernelModel(
        name=f"flash_attention_bwd.stats.{dtype}", grid=(n_st, bh, 1),
        threads=256, smem=0,
        inputs=[OperandSpec(nm, (bh, sq, d), (1, fab.STAT_ROWS, d),
                            lambda x, y, z: (y, x * fab.STAT_ROWS, 0),
                            masked=(1,)) for nm in ("o", "do")]
        + [OperandSpec("lse", (bh, sq), (1, fab.STAT_ROWS),
                       lambda x, y, z: (y, x * fab.STAT_ROWS), masked=(1,))],
        outputs=[OperandSpec("stats", (bh, n_st, 2, fab.STAT_ROWS),
                             (1, 1, 2, fab.STAT_ROWS),
                             lambda x, y, z: (y, x, 0, 0))],
        size_tag=tag)
    kb, qb = p.dkdv_keys, p.dq_rows
    n_kt, n_qt = -(-skv // kb), -(-sq // qb)
    # the D = 256 route's blocks of one key tile (y) split its group's
    # heads and merge their partials into one tile
    split = -(-kv_group // fab.heads_per_block(d, dt, bh, skv, kv_group))
    if p.route == "wgmma":
        def kv_of(x, y):
            return x % n_kv, x // n_kv * kb

        def q_of(x, y):
            return x % bh, (n_qt - 1 - x // bh) * qb
        dkdv_grid, dq_grid = (n_kt * n_kv, split, 1), (n_qt * bh, 1, 1)
    else:
        def kv_of(x, y):
            return y, x * kb

        def q_of(x, y):
            return y, (n_qt - 1 - x) * qb
        dkdv_grid, dq_grid = (n_kt, n_kv, 1), (n_qt, bh, 1)
    # a dK/dV block walks every query row of its KV head's group
    q_in = [OperandSpec(nm, (bh, sq, d), (kv_group, sq, d),
                        lambda x, y, z: (kv_of(x, y)[0] * kv_group, 0, 0))
            for nm in ("q", "do")]
    kv_in = [OperandSpec(nm, (n_kv, skv, d), (1, kb, d),
                         lambda x, y, z: (kv_of(x, y)[0], kv_of(x, y)[1], 0),
                         masked=(1,)) for nm in ("k", "v")]
    dkdv = KernelModel(
        name=f"flash_attention_bwd.dkdv.{dtype}", grid=dkdv_grid,
        threads=256, smem=p.dkdv_smem, merge_dims=(1,) if split > 1 else (),
        inputs=q_in + kv_in,
        outputs=[OperandSpec(nm, (n_kv, skv, d), (1, kb, d),
                             lambda x, y, z: (kv_of(x, y)[0],
                                              kv_of(x, y)[1], 0),
                             masked=(1,)) for nm in ("dk", "dv")],
        size_tag=tag)
    dq = KernelModel(
        name=f"flash_attention_bwd.dq.{dtype}", grid=dq_grid, threads=256,
        smem=p.dq_smem,
        inputs=[OperandSpec(nm, (bh, sq, d), (1, qb, d),
                            lambda x, y, z: (q_of(x, y)[0], q_of(x, y)[1],
                                             0), masked=(1,))
                for nm in ("q", "do")]
        + [OperandSpec(nm, (n_kv, skv, d), (1, skv, d),
                       lambda x, y, z: (q_of(x, y)[0] // kv_group, 0, 0))
           for nm in ("k", "v")],
        outputs=[OperandSpec("dq", (bh, sq, d), (1, qb, d),
                             lambda x, y, z: (q_of(x, y)[0], q_of(x, y)[1],
                                              0), masked=(1,))],
        size_tag=tag)
    return [prep, dkdv, dq], []


def decode_attention_model(b: int = 8, h: int = 1, kvh: int = 1,
                           s: int = 2048, d: int = 64,
                           dtype: str = "bfloat16"
                           ) -> Tuple[List[KernelModel], List[Finding]]:
    """``csrc/decode_attention.cu`` (``decode_attention.plan``): block
    (x, y) takes split x of row group y (slot ``y // KV``, KV head ``y %
    KV``), ``chunk`` keys of the cache from ``x * chunk`` (keys past the
    slot's length masked); the group's splits merge in one block, which
    writes the output rows and log-sum-exps.  Its partials and merge
    counters are scratch kept per (device, stream), or a captured graph's
    own (``decode_attention.scratch_key``).  The plan's route names the
    model: ``decode_attention.<dtype>`` for the CUDA-core kernel,
    ``decode_attention.hmma.bfloat16`` for the tensor-core route, whose
    block also holds the group's 16-row Q tile and the split merge's
    weights (``decode_attention.block_smem``)."""
    import torch

    from repro_torch.kernels import decode_attention as da
    dt = getattr(torch, dtype)
    if d not in da.HEAD_DIMS or h % kvh or h // kvh > da.max_group(d, dt):
        return [], [Finding(
            "K001", ERROR, f"decode_attention: D={d}, H/KV={h}/{kvh} "
            f"({dtype}) is past what the kernel takes — the wrapper refuses",
            subject="decode_attention")]
    p = da.plan(b, h, kvh, s, d, dt)
    rep = h // kvh
    floats = b * h * p.n_splits * (d + 2)
    route = "" if p.route == "lanes" else f"{p.route}."

    def group(x, y, z):
        return y // kvh, (y % kvh) * rep

    cache = [OperandSpec(nm, (b, s, kvh, d), (1, p.chunk, 1, d),
                         lambda x, y, z: (y // kvh, x * p.chunk, y % kvh, 0),
                         masked=(1,)) for nm in ("k_cache", "v_cache")]
    return [KernelModel(
        name=f"decode_attention.{route}{dtype}",
        grid=(p.n_splits, b * kvh, 1),
        threads=da.THREADS, smem=da.block_smem(p, rep, d, dt),
        inputs=[OperandSpec("q", (b, h, d), (1, rep, d),
                            lambda x, y, z: (*group(x, y, z), 0))] + cache
        + [OperandSpec("lens", (b,), (1,), lambda x, y, z: (y // kvh,))],
        outputs=[OperandSpec("out", (b, h, d), (1, rep, d),
                             lambda x, y, z: (*group(x, y, z), 0)),
                 OperandSpec("lse", (b, h), (1, rep),
                             lambda x, y, z: group(x, y, z))],
        merge_dims=(0,),
        scratch=[ScratchSpec(f"partials ({floats} floats) and counters",
                             _store_entry(da.scratch_key))],
        size_tag=f"b{b} h{h} kv{kvh} s{s} d{d}")], []


def _store_entry(scratch_key: Callable) -> Callable:
    """(stream, graph) -> the identity of the store and entry a launch on
    the card's stream uses (``scratch_key`` gives the store and key)."""
    def key(stream, graph):
        store, entry = scratch_key("cuda:0", stream, graph)
        return id(store), entry
    return key


def default_factories() -> List[Callable]:
    """Every kernel at the reference's representative sizes, on each of
    its routes: fp32 and bf16 matmul, bf16 (tensor cores) and fp32 (CUDA
    cores) flash forward and backward and decode (bf16 decode on both
    routes: one query head a KV head on the CUDA cores, grouped ones on the
    tensor cores), real and complex tdFIR."""
    import functools
    out: List[Callable] = []
    for dtype in ("float32", "bfloat16"):
        out.append(functools.partial(matmul_model, dtype=dtype))
    # bf16's TMA routes: 64 x 64 and 128 x 256 tiles
    for m, n, k in ((512, 512, 512), (8192, 8192, 2048)):
        out.append(functools.partial(matmul_model, m, n, k, dtype="bfloat16"))
    for dtype in ("float32", "bfloat16"):
        out.append(functools.partial(flash_attention_model, dtype=dtype))
        out.append(functools.partial(flash_attention_bwd_model, dtype=dtype))
        out.append(functools.partial(decode_attention_model, dtype=dtype))
    # the bf16 decode's tensor-core route: command-r-plus's 12 query heads
    # a KV head, and recurrentgemma's ring (10 heads at D = 256, 8 splits)
    out.append(functools.partial(decode_attention_model, 4, 96, 8, 2112,
                                 128))
    out.append(functools.partial(decode_attention_model, 4, 10, 1, 2048,
                                 256))
    out += [tdfir_model, functools.partial(tdfir_model, planes=2)]
    return out


def kernel_models(factories: Optional[Sequence[Callable]] = None
                  ) -> Tuple[List[KernelModel], List[Finding]]:
    models, findings = [], []
    for build in (default_factories() if factories is None else factories):
        got, errs = build()
        findings.extend(errs)
        models.extend(got)
    return models, findings


def lint_kernels(factories: Optional[Sequence[Callable]] = None
                 ) -> List[Finding]:
    """All K-findings for the kernels (default: :func:`default_factories`);
    a clean launch is reported as one K001 info a model."""
    models, findings = kernel_models(factories)
    for model in models:
        got = check_model(model)
        findings.extend(got or [Finding(
            "K001", INFO, f"launch {model.grid} x {model.threads} threads, "
            f"{model.smem} B shared: every output element written once, "
            f"every access in bounds [{model.size_tag}]",
            subject=model.name)])
    return findings

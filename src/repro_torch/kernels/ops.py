"""Device dispatch for the kernels, and their launch counters.

A CPU tensor takes the plain PyTorch version (:mod:`repro_torch.kernels.ref`);
a CUDA tensor launches the hand-written CUDA kernel, and a build or launch
failure raises — there is no fallback.  Each kernel module counts its own
launches; :func:`launch_counts` reads them and :func:`reset_launch_counts`
sets them to 0.  A wrapper counts a launch when Python calls it, so a CUDA
graph (:class:`CountedGraph`) takes back the launches its capture recorded
(nothing ran) and adds them again on every replay (they all run).

Training reaches flash attention through :class:`FlashAttention`, an
autograd function whose forward also saves each row's log-sum-exp
(:func:`flash_attention_lse`) and whose backward is the hand-written
backward kernel (``flash_attention_bwd``; on CPU tensors,
``ref.mha_backward_ref``), which reads it; :func:`flash_attention` takes it
only under grad mode with an input that requires grad, so serving launches
exactly what it did before.

A fake tensor (``torch._subclasses.FakeTensor``: shape and dtype, no data)
reaching a wrapper, on either device, neither launches nor runs the plain
version: the wrapper refuses what its kernel refuses, returns empty
results of the kernel's shapes and dtypes and hands the kernel's work,
from the formula kept beside its plan (``matmul.work``, ``tdfir.work``,
``tdfir.complex_work``, ``flash_attention.work``,
``flash_attention_bwd.work``, ``decode_attention.work``), with the
operands' dtype, to the analysis that is tracing (:func:`recording_work`).
The check is an ``isinstance`` on each operand (any fake operand takes the
fake path: a trace may close over a real tensor beside fake ones), made
before the device check, so a fake CPU tensor never runs the plain
version; a real launch pays nothing measurable for it.

DTensor has no sharding rule for these kernels.  A DTensor operand (the
mesh bridge traces a candidate on DTensor shards, ``dist.bridge``) is
gathered whole (a counted all-gather), the wrapper runs on the whole
tensors, and its results are replicated: the way the trace runs any op
DTensor cannot shard (``core.trace_analysis``).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import (_disable_current_modes,
                                          _get_current_dispatch_mode_stack)

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref
from repro_torch.kernels import tdfir as _fir

_KERNELS = {"matmul": _mm, "tdfir": _fir, "flash_attention": _fa,
            "decode_attention": _da, "flash_attention_bwd": _fab}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# per thread, the work sink of the analysis tracing now
_tls = threading.local()


@contextmanager
def recording_work(sink: Callable[[str, float, float, torch.dtype], None]):
    """Hand ``sink(kernel, flops, nbytes, dtype)`` the work of every
    fake-tensor kernel call this thread makes inside the block (the trace
    analysis, ``repro_torch.core.trace_analysis``); ``dtype`` is the
    operands', whose peak the FLOPs are priced at.  A thread with no sink
    of its own takes the ``work_sink`` of a dispatch mode on its stack:
    the autograd engine runs a backward on cards on threads of its own,
    carrying the tracing mode there but not this thread's sink."""
    saved = getattr(_tls, "sink", None)
    _tls.sink = sink
    try:
        yield
    finally:
        _tls.sink = saved


def _fake_of(*tensors: torch.Tensor) -> Optional[FakeTensor]:
    """The first fake operand, or None when every operand is real."""
    for t in tensors:
        if isinstance(t, FakeTensor):
            return t
    return None


def _replicated(kernel: Callable, *args, **kw):
    """``kernel`` on ``args`` gathered whole, when one is a DTensor (None
    otherwise): its results replicated over the operand's mesh."""
    mesh = next((t.device_mesh for t in args if isinstance(t, DTensor)),
                None)
    if mesh is None:
        return None
    rep = [Replicate()] * mesh.ndim
    out = kernel(*[t.redistribute(mesh, rep).to_local()
                   if isinstance(t, DTensor) else t for t in args], **kw)

    def wrap(t):
        return DTensor.from_local(t, mesh, rep, run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _fake_call(name: str, work: Tuple[float, float],
               dtype: torch.dtype) -> None:
    sink = getattr(_tls, "sink", None)
    if sink is None:            # an autograd thread: the tracing mode's
        sink = next((m.work_sink for m in _get_current_dispatch_mode_stack()
                     if getattr(m, "work_sink", None) is not None), None)
    if sink is not None:
        sink(name, *work, dtype)


def _fir_shapes(xs, hs) -> Tuple[int, int, int]:
    """(F, N, K) of fake FIR operands, refused as the kernel refuses them."""
    x, h = xs[0], hs[0]
    if (x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]
            or any(t.shape != x.shape for t in xs)
            or any(t.shape != h.shape for t in hs)
            or any(t.dtype != torch.float32 for t in (*xs, *hs))):
        raise ValueError(f"tdfir operands x {[tuple(t.shape) for t in xs]}, "
                         f"h {[tuple(t.shape) for t in hs]}")
    return x.shape[0], x.shape[1], h.shape[1]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = _replicated(matmul, a, b)
    if out is not None:
        return out
    fake = _fake_of(a, b)
    if fake is not None:
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(f"matmul shapes {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}")
        _fake_call("matmul", _mm.work(a.shape[0], b.shape[1], a.shape[1],
                                      a.element_size()), a.dtype)
        return fake.new_empty((a.shape[0], b.shape[1]), dtype=a.dtype)
    if _on_cpu(a, b):
        return ref.matmul_ref(a, b)
    return _mm.matmul(a, b)


def tdfir(x: torch.Tensor, h: torch.Tensor, block_n: int = 512
          ) -> torch.Tensor:
    out = _replicated(tdfir, x, h, block_n=block_n)
    if out is not None:
        return out
    fake = _fake_of(x, h)
    if fake is not None:
        _fake_call("tdfir", _fir.work(*_fir_shapes((x,), (h,))), x.dtype)
        return fake.new_empty(x.shape, dtype=x.dtype)
    if _on_cpu(x, h):
        return ref.tdfir_ref(x, h)
    return _fir.tdfir(x, h, block_n=block_n)


def tdfir_complex(x_re, x_im, h_re, h_im, block_n: int = 512):
    out = _replicated(tdfir_complex, x_re, x_im, h_re, h_im,
                      block_n=block_n)
    if out is not None:
        return out
    fake = _fake_of(x_re, x_im, h_re, h_im)
    if fake is not None:
        shape = _fir_shapes((x_re, x_im), (h_re, h_im))
        _fake_call("tdfir_complex", _fir.complex_work(*shape), x_re.dtype)
        return (fake.new_empty(x_re.shape, dtype=x_re.dtype),
                fake.new_empty(x_re.shape, dtype=x_re.dtype))
    if _on_cpu(x_re, x_im, h_re, h_im):
        return ref.tdfir_complex_ref(x_re, x_im, h_re, h_im)
    return _fir.tdfir_complex(x_re, x_im, h_re, h_im, block_n=block_n)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_group: int = 1, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """q [BH, Sq, D], k/v [BH // kv_group, Skv, D] -> [BH, Sq, D];
    ``window`` > 0 keeps keys with ``qpos - kpos < window``, ``softcap`` > 0
    caps the scaled scores at ``c tanh(s / c)``, and query row ``i`` sits
    at position ``qpos = i + q_offset``.  Under grad mode with an input
    that requires grad it goes through :class:`FlashAttention` (the
    backward kernel on the card); otherwise (serving) it is the forward
    call alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, kv_group, window,
                                    softcap, q_offset)
    return _flash_forward(q, k, v, causal, kv_group, window, softcap,
                          q_offset)


def _flash_shapes(q, k, v, kv_group: int, window: int, *more,
                  softcap: float = 0.0, q_offset: int = 0):
    """(BH, Sq, Skv, D) of fake flash operands (``more``: o and do, shaped
    as q), refused as the kernels refuse them."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or any(t.shape != q.shape for t in more):
        raise ValueError(f"flash attention takes q [BH,S,D] and k/v "
                         f"[BH/kv_group,S,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if kv_group < 1 or k.shape[0] * kv_group != bh or k.shape[2] != d:
        raise ValueError(f"k/v rows {k.shape[0]} x kv_group {kv_group} must "
                         f"equal q rows {bh}, with head dim {d}")
    if d not in _fa.HEAD_DIMS:
        raise ValueError(f"CUDA flash attention takes head dim D in "
                         f"{_fa.HEAD_DIMS}, got {d}")
    _fa.check_masks(window, q_offset, softcap)
    if len({t.dtype for t in (q, k, v, *more)}) != 1 \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"CUDA flash attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    return bh, sq, k.shape[1], d


def _flash_fake(fake, q, k, v, causal, kv_group, window, softcap, q_offset,
                lse: bool):
    """The fake forward: its work reported, empty out (and lse)."""
    bh, sq, skv, d = _flash_shapes(q, k, v, kv_group, window,
                                   softcap=softcap, q_offset=q_offset)
    _fake_call("flash_attention",
               _fa.work(bh, sq, skv, d, kv_group, causal, window,
                        q.element_size(), lse=lse, q_offset=q_offset),
               q.dtype)
    out = fake.new_empty((bh, sq, d), dtype=q.dtype)
    if not lse:
        return out
    return out, fake.new_empty((bh, sq), dtype=torch.float32)


def _flash_forward(q, k, v, causal, kv_group, window, softcap, q_offset):
    masks = dict(window=window, softcap=softcap, q_offset=q_offset)
    out = _replicated(_flash_forward, q, k, v, causal, kv_group, window,
                      softcap, q_offset)
    if out is not None:
        return out
    fake = _fake_of(q, k, v)
    if fake is not None:
        return _flash_fake(fake, q, k, v, causal, kv_group, window, softcap,
                           q_offset, False)
    if _on_cpu(q, k, v):
        return ref.mha_ref(q, k, v, causal=causal, kv_group=kv_group,
                           **masks)
    return _fa.flash_attention(q, k, v, causal=causal, kv_group=kv_group,
                               **masks)


def flash_attention_lse(q, k, v, *, causal: bool = True, kv_group: int = 1,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0):
    """The forward alone, also returning each row's log-sum-exp: (out
    [BH, Sq, D], lse float32 [BH, Sq], base 2, of the capped scores under
    a cap; see ``kernels.flash_attention.flash_attention``), what the
    backward takes."""
    masks = dict(window=window, softcap=softcap, q_offset=q_offset)
    out = _replicated(flash_attention_lse, q, k, v, causal=causal,
                      kv_group=kv_group, **masks)
    if out is not None:
        return out
    fake = _fake_of(q, k, v)
    if fake is not None:
        return _flash_fake(fake, q, k, v, causal, kv_group, window, softcap,
                           q_offset, True)
    if _on_cpu(q, k, v):
        return ref.mha_ref(q, k, v, causal=causal, kv_group=kv_group,
                           return_lse=True, **masks)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    out = _fa.flash_attention(q, k, v, causal=causal, kv_group=kv_group,
                              lse=lse, **masks)
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        kv_group: int = 1, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v with output
    ``o`` and row log-sum-exps ``lse`` (:func:`flash_attention_lse`),
    given the output's gradient ``do``."""
    masks = dict(window=window, softcap=softcap, q_offset=q_offset)
    out = _replicated(flash_attention_bwd, q, k, v, o, do, lse,
                      causal=causal, kv_group=kv_group, **masks)
    if out is not None:
        return out
    fake = _fake_of(q, k, v, o, do, lse)
    if fake is not None:
        bh, sq, skv, d = _flash_shapes(q, k, v, kv_group, window, o, do,
                                       softcap=softcap, q_offset=q_offset)
        if tuple(lse.shape) != (bh, sq) or lse.dtype != torch.float32:
            raise ValueError(f"flash attention backward takes the forward's "
                             f"lse as a float32 [{bh}, {sq}], got "
                             f"{lse.dtype} {tuple(lse.shape)}")
        _fake_call("flash_attention_bwd",
                   _fab.work(bh, sq, skv, d, kv_group, causal, window,
                             q.element_size(), q_offset=q_offset), q.dtype)
        return (fake.new_empty(q.shape, dtype=q.dtype),
                fake.new_empty(k.shape, dtype=q.dtype),
                fake.new_empty(k.shape, dtype=q.dtype))
    if _on_cpu(q, k, v, o, do, lse):
        return ref.mha_backward_ref(q, k, v, o, do, lse, causal=causal,
                                    kv_group=kv_group, **masks)
    return _fab.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                    kv_group=kv_group, **masks)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward kernel, which saves
    q, k, v, its output and each row's log-sum-exp, and the backward kernel
    (on CPU tensors, the plain versions of both).  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward pass,
    counts its launch again and saves its log-sum-exp again."""

    @staticmethod
    def forward(ctx, q, k, v, causal, kv_group, window, softcap, q_offset):
        out, lse = flash_attention_lse(q, k, v, causal=causal,
                                       kv_group=kv_group, window=window,
                                       softcap=softcap, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, kv_group, window, softcap, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, kv_group, window, softcap, q_offset = ctx.mask
        do = do.contiguous()    # a broadcast or strided grad: TMA loads it
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=causal, kv_group=kv_group,
                                         window=window, softcap=softcap,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None, None, None


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     lse: Optional[torch.Tensor] = None,
                     softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, D]; caches [B, S, KV, D]; per-row ``cache_len`` -> [B, H,
    D].  ``lse``, an fp32 [B, H] tensor, receives each row's base-2
    log-sum-exp (``-1e30`` for a row of length 0, whose output is 0), as
    :func:`flash_attention_lse` gives the forward's; ``softcap`` > 0 caps
    the scaled scores at ``c tanh(s / c)``.

    A fake call reports the work of the valid rows its lengths give
    (``decode_attention.valid_rows``); lengths held in a fake tensor cannot
    be read, and then every row counts the whole cache: an upper bound."""
    out = _replicated(decode_attention, q, k_cache, v_cache, cache_len,
                      lse=lse, softcap=softcap)
    if out is not None:
        return out
    fake = _fake_of(q, k_cache, v_cache)
    if fake is not None:
        b, h, kvh, s_len, d = _decode_shapes(q, k_cache, v_cache)
        _fa.check_masks(0, 0, softcap, "decode attention")
        lens = cache_len
        if isinstance(cache_len, FakeTensor):
            lens = s_len
        elif isinstance(cache_len, torch.Tensor):   # real: read on the host
            with _disable_current_modes():
                lens = cache_len.reshape(-1).tolist()
        _fake_call("decode_attention",
                   _da.work(b, h, kvh, d, _da.valid_rows(lens, b, s_len),
                            q.element_size(), lse=lse is not None), q.dtype)
        return fake.new_empty((b, h, d), dtype=q.dtype)
    if _on_cpu(q, k_cache, v_cache):
        if lse is None:
            return ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                            softcap=softcap)
        out, got = ref.decode_attention_ref(q, k_cache, v_cache, cache_len,
                                            return_lse=True, softcap=softcap)
        lse.copy_(got)
        return out
    return _da.decode_attention(q, k_cache, v_cache, cache_len, lse=lse,
                                softcap=softcap)


def _decode_shapes(q, k_cache, v_cache):
    """(B, H, KV, S, D) of fake decode operands, refused as the kernel
    refuses them."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode attention takes q [B,H,D] and caches "
                         f"[B,S,KV,D], got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    _, s_len, kvh, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != d or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} does not group over the cache "
                         f"{tuple(k_cache.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"CUDA decode attention takes float32 or bfloat16 "
                        f"q/caches of one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if d not in _da.HEAD_DIMS:
        raise ValueError(f"CUDA decode attention takes head dim D in "
                         f"{_da.HEAD_DIMS}, got D={d}")
    if h // kvh > _da.max_group(d, q.dtype):
        raise ValueError(f"CUDA decode attention takes H/KV <= "
                         f"{_da.max_group(d, q.dtype)} at D={d} in "
                         f"{q.dtype}, got {h // kvh}")
    return b, h, kvh, s_len, d


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` whose replays count the kernel launches it
    holds: :meth:`capture` records how many launches each kernel's wrapper
    made while capturing (and takes them back out of the counters, since a
    captured launch does not run); :meth:`replay` runs the graph and adds
    them.  The decode kernel's scratch in the graph is the graph's own
    (``scratch``), so graphs replayed on any streams never share it."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: Dict[str, int] = {}
        self.scratch: dict = {}

    @contextmanager
    def capture(self, stream: torch.cuda.Stream):
        """Capture the block's work on ``stream`` (which must have run the
        same work once before, so that kernels are built and library
        workspaces made outside the capture)."""
        before = launch_counts()
        try:
            with _da.graph_scratch(self.scratch), \
                    torch.cuda.graph(self.graph, stream=stream):
                yield self
        finally:
            after = launch_counts()
            for name, mod in _KERNELS.items():
                n = after[name] - before[name]
                mod.launches -= n
                self.launches[name] = n

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            _KERNELS[name].launches += n


@contextmanager
def no_device_work():
    """Forbid traces, graph captures and kernel launches inside the block.

    The warm read paths (router, fleet planner, control loop) promise pure
    arithmetic over published analyses.  Inside this block
    ``trace_analysis.trace`` and ``CountedGraph`` raise ``AssertionError``
    when reached, and on exit a launch that any kernel's counter recorded
    raises too.  Tests and ``chip_smoke.py`` hold those paths to it."""
    from repro_torch.core import trace_analysis

    def poisoned(*args, **kw):
        raise AssertionError("a warm read path attempted a trace or capture")

    saved_trace, saved_init = trace_analysis.trace, CountedGraph.__init__
    before = launch_counts()
    trace_analysis.trace = poisoned
    CountedGraph.__init__ = poisoned
    try:
        yield
    finally:
        trace_analysis.trace = saved_trace
        CountedGraph.__init__ = saved_init
    moved = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
    if moved:
        raise AssertionError(f"a warm read path launched kernels: {moved}")

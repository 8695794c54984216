"""Single-clip audio tagging (port of efficientat_tpu/infer/tag.py;
reference surface: upstream inference.py:15-63).

One ``predict`` call (span ``tag.predict``): the batch is staged in a
pinned host buffer (``tag.stage``), in row chunks on a pool of host threads
where it is large (``stage_rows``), and each chunk's copy to the device
(``tag.h2d``, inside ``tag.stage``) is issued as soon as its rows have
landed; it is decoded there (``tag.decode``) (f32 / int16 / mu-law uint8), turned into log-mels
by ``log_mel_spectrogram_fused`` with the front end of the members' registry
spec (K1 on CUDA for EfficientAT's ``MelConfig``; the plain path for
HTS-AT's ``LibrosaMelConfig``, whose log-mel comes time before mels;
``tag.mel``), run through
every member (a DyMN at its ``cfg.t_max``, the final temperature of its
training; ``tag.members``, and inside it ``tag.member.mn``,
``tag.member.dymn``, ``tag.member.passt`` or ``tag.member.htsat`` around
each member by its
family, all timed on the device too, and the members' logits averaged in
fp32; inside a PaSST member its blocks' ``passt.attn`` and ``passt.mlp``
spans and the counters ``passt.launch.attn`` and ``passt.tokens``,
``models/passt.py``; inside an HTS-AT member its blocks' ``htsat.attn`` and
``htsat.window`` spans and its counters, ``models/htsat.py``), the sigmoid is taken
(``tag.sigmoid``), and the probs are read back, where the host waits for the device (``tag.readback``). The whole
batch runs at once, but where its members run as CUDA graphs (below): the
JAX Tagger's DyMN micro-batching is a TPU workaround.

``dtype=torch.bfloat16`` runs the members under ``torch.autocast``; the mel
stays fp32 (K1 at ``dft_precision``, outside the autocast), as upstream
keeps its front end out of autocast (models/preprocess.py:56-57). Autocast
rounds the convs' and Linears' operands to bf16 and keeps BatchNorm in fp32,
where the JAX Tagger's flax ``dtype`` computes BatchNorm in bf16 too.

On CUDA, while spans are off, HTS-AT members' forwards are captured as CUDA
graphs at the part's mel shape and replayed (``_Graphed``;
``tag.graph.capture`` counts the captures), and the batch is served in
``GRAPH_PARTS`` parts (``_parts``): the first part is staged and launched,
then the next is staged while the card works on it, and so on. Only the
first part's staging then delays a call, and a host that stalls later no
longer idles the card. With spans on the whole batch runs eagerly, so that
the blocks' spans time them.

MN, DyMN and PaSST members mix freely: their mel configs are equal, so
one log-mel feeds them all. HTS-AT's front end is its own, so it is served
alone or beside other HTS-AT members.

``mesh`` (a ``parallel/mesh.py::Mesh``) serves a same-architecture ensemble
member-parallel (of MN, DyMN or PaSST members alike), as the JAX Tagger
does over its ``("data", "model")`` mesh: each rank holds its share of the
stacked members, computes the mel of its data index's rows (K1-dp where
there is more than one rank), and the ranks meet in one all-reduce of
logits over the model group and one of probs over the data group.
"""

from __future__ import annotations

import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from efficientat_tpu_torch.data.wavecodec import decode
from efficientat_tpu_torch.models.dymn import DyMN
from efficientat_tpu_torch.models.htsat import HTSAT
from efficientat_tpu_torch.models.mn import MN
from efficientat_tpu_torch.models.passt import PaSST
from efficientat_tpu_torch.models.registry import build_model, get_model_config
from efficientat_tpu_torch.ops.mel_kernel import log_mel_spectrogram_fused
from efficientat_tpu_torch.parallel.ensemble import (
    make_member_parallel_ensemble,
    shard_member_params,
    stack_member_params,
)
from efficientat_tpu_torch.parallel.mesh import Mesh
from efficientat_tpu_torch.utils.labels import AUDIOSET_LABELS
from efficientat_tpu_torch.utils.profiling import COUNTERS, count, span, spans_on


# by family: the span of a served member's forward inside ``tag.members``,
# and the forward's arguments after the mel (a DyMN runs at its
# ``cfg.t_max``, the final temperature of its training)
_FAMILIES = {
    MN: ("tag.member.mn", lambda model: ()),
    DyMN: ("tag.member.dymn", lambda model: (model.cfg.t_max,)),
    PaSST: ("tag.member.passt", lambda model: ()),
    HTSAT: ("tag.member.htsat", lambda model: ()),
}


def _serving_args(model: nn.Module) -> tuple:
    """A served member's forward arguments after the mel, by family."""
    return _FAMILIES[type(model)][1](model)


def _host_batch(waves) -> np.ndarray:
    """The caller's batch as a (B, num_samples) array, as it is: no copy, no
    cast (``stage_rows`` casts while it stages)."""
    return np.atleast_2d(np.asarray(waves))


def _transport_dtype(waves: np.ndarray) -> np.dtype:
    """The dtype a batch travels in: int16 and uint8 as they are, anything
    else float32."""
    return waves.dtype if waves.dtype in (np.int16, np.uint8) else np.dtype(np.float32)


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int16): torch.int16,
                 np.dtype(np.uint8): torch.uint8}

# A batch of at least this many bytes (in its transport dtype) and of more
# than one row is staged in row chunks on the staging pool; a smaller one on
# the calling thread, where the pool's hand-off costs more than it saves.
STAGE_MIN_BYTES = 4 << 20
# staging threads at most: of 4, 8 and 16, 8 staged fastest and served most
# on an 8-CPU H100 host (PERF.md)
STAGE_THREADS = 8
# row chunks a staging thread: the copy to the device of the last chunk, the
# one part not hidden behind the staging, is small
CHUNKS_A_THREAD = 2

# Where the members run as CUDA graphs (HTS-AT on the card), a batch is
# served in up to this many parts of at least PART_MIN_ROWS rows: the
# staging of every part but the first overlaps the device's work on the
# parts before it, so that only the first part's staging delays a call
GRAPH_PARTS = 2
PART_MIN_ROWS = 16
# graphs kept by a Tagger (member, mel shape): the last used
GRAPHS_KEPT = 4

_pool: Optional[Tuple[ThreadPoolExecutor, int]] = None
_pool_lock = threading.Lock()


def _stage_pool() -> Tuple[ThreadPoolExecutor, int]:
    """The process's staging threads and their count, made on first use and
    shared by every Tagger: one a CPU the process may run on, at most
    ``STAGE_THREADS``."""
    global _pool
    with _pool_lock:
        if _pool is None:
            threads = min(len(os.sched_getaffinity(0)), STAGE_THREADS)
            _pool = (ThreadPoolExecutor(threads, thread_name_prefix="tag.stage"), threads)
        return _pool


def stage_rows(dst: np.ndarray, waves: np.ndarray,
               landed: Callable[[int, int], None]) -> None:
    """Copy ``waves`` into ``dst`` of the same shape, cast to ``dst``'s dtype
    as ``np.ascontiguousarray(waves, dtype=dst.dtype)`` would, and call
    ``landed(start, stop)`` for each range of rows once it is in ``dst``, in
    row order. A batch of ``STAGE_MIN_BYTES`` or more and of more than one
    row goes in row chunks (``CHUNKS_A_THREAD`` a thread) on the staging
    pool, counted by ``tag.stage.chunks``; numpy's copy releases the GIL, so
    the threads copy at once and ``landed`` runs while later chunks are
    still being copied. Any other batch goes in one piece on the calling
    thread (``tag.stage.serial``)."""
    if waves.shape != dst.shape:
        raise ValueError(f"staging {waves.shape} rows into a buffer of {dst.shape}")
    rows = len(dst)
    if dst.nbytes < STAGE_MIN_BYTES or rows < 2:
        count("tag.stage.serial")
        dst[...] = waves
        landed(0, rows)
        return
    pool, threads = _stage_pool()
    n = min(rows, CHUNKS_A_THREAD * threads)
    bounds = [rows * i // n for i in range(n + 1)]
    chunks = list(zip(bounds, bounds[1:]))
    futures = [pool.submit(np.copyto, dst[a:b], waves[a:b], casting="unsafe")
               for a, b in chunks]
    count("tag.stage.chunks", n)
    try:
        for (a, b), future in zip(chunks, futures):
            future.result()
            landed(a, b)
    finally:
        # no thread writes into dst after this returns, nor after it raises
        wait(futures)


def _member_logits(model: nn.Module, mel: torch.Tensor) -> torch.Tensor:
    return model(mel, *_serving_args(model))[0]


class _Graphed:
    """A member's serving forward at one mel shape, captured once as a CUDA
    graph and replayed: the call's hundreds of launches become one, so the
    host's pace no longer reaches the device time once the batch is
    staged. The mel is copied into the graph's input, and the logits are
    copied out of its output, which the next replay overwrites. The
    weights are read where they lie, so a ``load_state_dict`` after the
    capture is seen. The counters a forward adds are counted once a replay,
    and neither the warm-up nor the capture counts."""

    def __init__(self, model: nn.Module, mel: torch.Tensor):
        counts = dict(COUNTERS)
        self.mel = mel.clone()
        try:
            # warm up on a side stream before the capture, as CUDA graphs ask
            side = torch.cuda.Stream(mel.device)
            side.wait_stream(torch.cuda.current_stream(mel.device))
            with torch.cuda.stream(side):
                _member_logits(model, self.mel)
            torch.cuda.current_stream(mel.device).wait_stream(side)
            COUNTERS.clear()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.logits = _member_logits(model, self.mel)
            self.counts = dict(COUNTERS)
        finally:
            COUNTERS.clear()
            COUNTERS.update(counts)
        count("tag.graph.capture")

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        self.mel.copy_(mel)
        self.graph.replay()
        for name, n in self.counts.items():
            count(name, n)
        return self.logits.clone()


def _member_span(model: nn.Module) -> str:
    """The span of a member's forward inside ``tag.members``, by family."""
    return _FAMILIES[type(model)][0]


class Tagger:
    """Audio tagger over one MN, DyMN, PaSST or HTS-AT model or an averaged
    ensemble of them.

    names: registry name(s), e.g. ``"mn10_as"``, ``"dymn10_as"``,
        ``"passt_s_swa_p16_128_ap476"`` or ``"htsat_tiny_as"``.
    pretrained: load ``<model_dir>/<release file>`` for every member; with
        ``False`` member ``i`` gets upstream's init drawn from
        ``torch.Generator`` seeded ``seed + i`` on the CPU.
    device: where the models run; nothing is placed anywhere else.
    dft_precision: the mel DFT precision on the card, ``"bf16x3"`` (default)
        or ``"fp32"``.
    dtype: the members' compute dtype, ``torch.float32`` (default) or a
        lower one that they run in under ``torch.autocast``.
    mesh: this rank's place in a ``(data, model)`` layout of the ranks
        (``parallel.mesh.make_mesh``). With more than one member, all of
        one class and config, and a member count that the model axis
        divides, the members are stacked and this rank keeps only its
        ``shard_member_params`` on ``device`` (``_stacked``): per-rank
        parameter memory stays flat. Any other ensemble, and ``mesh=None``,
        takes the replicated path, where every rank computes the whole
        batch. Under a mesh every rank calls ``predict`` with the same whole
        batch, as each process under ``torchrun`` does, and gets the same
        probs back.
    """

    def __init__(
        self,
        names: Union[str, Sequence[str]],
        pretrained: bool = True,
        num_classes: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        model_dir: str = "resources",
        dft_precision: Optional[str] = None,
        seed: int = 0,
        labels: Sequence[str] = AUDIOSET_LABELS,
        dtype: torch.dtype = torch.float32,
        mesh: Optional[Mesh] = None,
    ):
        if isinstance(names, str):
            names = [names]
        self.device = torch.device(device)
        self.dft_precision = dft_precision
        self.dtype = dtype
        self.labels = list(labels)
        self.mel_cfg = get_model_config(names[0]).mel_cfg
        for name in names[1:]:
            other = get_model_config(name).mel_cfg
            if other != self.mel_cfg:
                raise ValueError(
                    f"ensemble members disagree on the mel front-end: "
                    f"{names[0]!r} uses {self.mel_cfg}, {name!r} uses {other}. "
                    "All members must share one mel config (reference "
                    "models/ensemble.py:25-33 feeds one spectrogram to all).")
        members = []
        for i, name in enumerate(names):
            if pretrained:
                from efficientat_tpu_torch.models.convert import load_pretrained

                model = load_pretrained(name, model_dir, num_classes=num_classes)
            else:
                model = build_model(name, num_classes=num_classes,
                                    generator=torch.Generator().manual_seed(seed + i))
                warnings.warn(f"{name}: using random weights (pretrained=False)")
            members.append(model.eval())
        self.mesh = mesh
        self._stacked = None
        m0 = members[0]
        if (mesh is not None and len(members) > 1
                and all(type(m) is type(m0) and m.cfg == m0.cfg for m in members)
                and len(members) % mesh.shape["model"] == 0):
            # the stack and this rank's share of it on the host; only the
            # share goes to the device, and the base module, which gives
            # the structure, holds no tensors
            self._stacked = {k: v.to(self.device) for k, v in shard_member_params(
                stack_member_params(members), mesh).items()}
            self._ensemble = make_member_parallel_ensemble(
                m0.to("meta"), mesh, len(members), _serving_args(m0))
            members = [m0]
            # this rank's share of the padded batch, by (data axis, data
            # index), whose probs predict puts together over the data
            # group; the mel as K1-dp where there is more than one rank
            self._data = (mesh.shape["data"], mesh.data_index)
            self._sharded = mesh.world > 1
        else:
            members = [m.to(self.device) for m in members]
            self._data = (1, 0)
            self._sharded = False
        # the replicated path's members; the member-parallel path's base
        self.members = members
        self._pinned: Optional[torch.Tensor] = None  # last batch's host buffer
        # the members' graphs by (member, mel shape, dtype, autocast), the
        # last used last
        self._graphs: dict = {}

    def _graphed(self) -> bool:
        """Whether the members run as CUDA graphs (``_Graphed``): HTS-AT
        members on CUDA on the replicated path, while spans are off. With
        spans on they run eagerly, so that their blocks' spans time them."""
        return (self.device.type == "cuda" and self._stacked is None and not spans_on()
                and all(isinstance(m, HTSAT) for m in self.members))

    def _graph(self, i: int, model: nn.Module, mel: torch.Tensor) -> _Graphed:
        """Member ``i``'s graph for ``mel``, captured (``tag.graph.capture``)
        the first time the mel's shape, dtype or autocast comes; the
        ``GRAPHS_KEPT`` last used are kept."""
        key = (i, tuple(mel.shape), mel.dtype, torch.is_autocast_enabled())
        graph = self._graphs.pop(key, None) or _Graphed(model, mel)
        self._graphs[key] = graph
        while len(self._graphs) > GRAPHS_KEPT:
            del self._graphs[next(iter(self._graphs))]
        return graph

    def _parts(self, rows: int) -> List[Tuple[int, int]]:
        """The row ranges a batch of ``rows`` is served in, one after the
        other: ``GRAPH_PARTS`` where the members run as graphs and every part
        holds ``PART_MIN_ROWS`` or more, else the whole batch at once."""
        parts = max(1, min(GRAPH_PARTS, rows // PART_MIN_ROWS)) if self._graphed() else 1
        bounds = [rows * i // parts for i in range(parts + 1)]
        return list(zip(bounds, bounds[1:]))

    def _stage(self, waves: np.ndarray, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The rows ``waves`` on the device, in their transport dtype; only
        the range ``rows`` of them where it is given. On CUDA they land in
        the batch's pinned buffer, in the same rows (``stage_rows``),
        allocated anew (``tag.pin_alloc``) only when the batch's shape or
        dtype changes, and each range of rows is copied on to the device
        (``tag.h2d``) on the current stream as soon as it has landed."""
        start, stop = rows or (0, len(waves))
        if self.device.type != "cuda":
            host = torch.from_numpy(np.ascontiguousarray(waves[start:stop],
                                                         _transport_dtype(waves)))
            with span("tag.h2d"):
                return host.to(self.device)
        dtype = _TORCH_DTYPES[_transport_dtype(waves)]
        buf = self._pinned
        if buf is None or buf.shape != waves.shape or buf.dtype != dtype:
            count("tag.pin_alloc")
            buf = self._pinned = torch.empty(waves.shape, dtype=dtype, pin_memory=True)
        x = torch.empty((stop - start,) + buf.shape[1:], dtype=dtype, device=self.device)

        def landed(a: int, b: int) -> None:
            with span("tag.h2d"):
                x[a:b].copy_(buf[start + a:start + b], non_blocking=True)

        # the previous copies out of these rows finished: predict ends by
        # reading its result back, which waits for the device, and the
        # parts of one batch take rows of their own
        stage_rows(buf.numpy()[start:stop], waves[start:stop], landed)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Staged rows ``x`` -> the members' mean logits: decode, the log-mel
        and the members, each in its span."""
        with span("tag.decode"):
            x = decode(x)
        with span("tag.mel"):
            mel = log_mel_spectrogram_fused(x, self.mel_cfg,
                                            dft_precision=self.dft_precision,
                                            sharded=self._sharded)
            # (B, 1, n_mels, frames); HTS-AT's (B, 1, frames, n_mels)
            mel = mel[:, None]
        with span("tag.members", device=True), torch.autocast(
                self.device.type, dtype=self.dtype,
                enabled=self.dtype != torch.float32):
            return self._mean_logits(mel)

    def _mean_logits(self, mel: torch.Tensor) -> torch.Tensor:
        """The members' mean logits in fp32: the stack's on the
        member-parallel path, else every member in turn, one
        ``tag.member.*`` span each."""
        if self._stacked is not None:
            return self._ensemble(self._stacked, mel)
        graphed = self._graphed()
        logits = []
        for i, model in enumerate(self.members):
            with span(_member_span(model), device=True):
                logits.append(self._graph(i, model, mel)(mel) if graphed
                              else _member_logits(model, mel))
        return sum(lg.float() for lg in logits) / len(self.members)

    def predict(self, waves: np.ndarray) -> np.ndarray:
        """waves (B, num_samples) at mel_cfg.sr, float32, int16 PCM or mu-law
        uint8 -> probs (B, classes) float32. Under a mesh every rank passes
        the same whole batch and gets the same probs: on the member-parallel
        path the batch is padded to a multiple of the data axis with the
        transport's silence (0, or 128 for mu-law), this rank's data index's
        rows go through decode and the mel, its members' logits are
        all-reduced over the model group (``make_member_parallel_ensemble``),
        and the rows of every data index are put together by an all-reduce
        of a zero-filled (padded batch, classes) buffer over the data group
        (``tag.all_reduce``; gloo reduces CUDA tensors but gathers none);
        the pad is sliced off."""
        n_data, index = self._data
        with span("tag.predict"), torch.inference_mode():
            with span("tag.stage"):
                waves = _host_batch(waves)
                n = waves.shape[0]
                pad = (-n) % n_data
                if pad:
                    silence = 128 if waves.dtype == np.uint8 else 0
                    waves = np.concatenate(
                        [waves, np.full((pad,) + waves.shape[1:], silence, waves.dtype)])
                rows = waves.shape[0] // n_data
                start = index * rows
                batch = waves[start:start + rows]
                parts = self._parts(rows)
                if len(parts) == 1:
                    x = self._stage(batch)
            if len(parts) == 1:
                logits = self._logits(x)
            else:
                # each part launched before the next is staged: the host's
                # staging of a part overlaps the device's work on the last
                logits = torch.cat([self._logits(self._stage(batch, part)) for part in parts])
            with span("tag.sigmoid"):
                probs = torch.sigmoid(logits)
            if n_data > 1:
                with span("tag.all_reduce"):
                    every = probs.new_zeros((waves.shape[0], probs.shape[1]))
                    every[start:start + rows] = probs
                    dist.all_reduce(every, group=self.mesh.data_group)
                    probs = every
            with span("tag.readback"):
                return probs[:n].cpu().numpy()

    def tag(self, path: str, top_k: int = 10) -> List[Tuple[str, float]]:
        """Decode an audio file and return the top-k (label, prob) pairs."""
        from efficientat_tpu_torch.data import load_waveform

        wave = load_waveform(path, target_sr=self.mel_cfg.sr)
        probs = self.predict(wave[None, :])[0]
        order = np.argsort(probs)[::-1][:top_k]
        return [(self.labels[i], float(probs[i])) for i in order]

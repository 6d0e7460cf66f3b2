"""A card wave's enumeration regions as one stream of float64 programs.

On a card run without a regions mesh, the bucket phasing
(``batch_driver.phase_regions_batched``) hands every enumeration region of a
wave that the router placed in float64 (``utils/device.phase_placement``:
all of them unless split mode is forced), regions phased alone and members
of enumeration buckets alike, to ``phase_enum_wave``. Each region runs the
float64 ascent program of its own (configs, K, I_pad) shape that
``optimize``'s per-region enumeration leg runs, chunk by chunk of its
configurations, with the keep-best of ``cuda_keep_best`` as the program's
last piece (kind "enum"): a chunk's program takes the running best of the
chunks before it and hands on only the winner's σ [K], δ, η [I_pad] and
objective, so nothing of [configs, K] outlives its launch. The host reads
nothing between the wave's first launch and its one sync, and its work for
a region is a few calls:

- every configuration's σ0 is drawn on the host from the region's numpy
  Generator, as the per-region path draws it, and checked there to share
  one active-read set (``optimize._first_member``);
- the wave's inputs go up in one copy from pinned memory: each region's
  cells, masks, η0 and σ0, every configuration's δ0 as ±1 int8, and the
  float64 slots of the results (each region's running best before its
  first chunk: no state, objective -inf); a program's load widens them
  into its float64 buffers on the card;
- the programs launch through ``graphs.Launches``: no sync, the card's lock
  held for each launch alone; each launch's winner and its set-condition
  census are copied, queued behind it, into slots of the wave;
- one copy brings every slot back; then the censuses are checked.

Same program, same inputs and the same per-region random stream as
``optimize.phase_region_on(..., split=False)``: the states are that path's,
byte for byte. On the CPU the plain executor walks the same programs (the
tests). Stage counts: ``phase_enum_wave_regions`` (regions phased here) and
``phase_enum_wave_syncs`` (the waves' reads; the plain executor's host
reads of loop flags are ``GRAPHS["flag_reads"]``).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import CallerConfig
from ..utils.spans import span, stage_add
from . import cuda_keep_best as KB
from . import graphs
from . import optimize as O
from .kernels import TIE_TOL, CompactCells, f64

# the inputs a program's load widens into float64 buffers
_WIDENED = {"sigma": f64, "delta": f64, "eta": f64}
# the packed inputs' types
_TORCH_TYPE = {np.dtype(np.float64): torch.float64,
               np.dtype(np.int64): torch.int64,
               np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
               np.dtype(bool): torch.bool}


def _region_arrays(frags, cands, seed: int, apply_ds: bool,
                   cfg: CallerConfig) -> dict:
    """One region's padded cells, masks, η0 and every configuration's σ0
    as the per-region path makes them (``optimize._phase_region_padded_impl``,
    its enumeration leg, from the same random stream), in their byte form:
    the values equal that path's float64 ones. Raises as ``_first_member``
    does where the configurations' active-read sets differ."""
    K0, I0 = frags.p.shape
    K, I_pad = O._bucket(max(1, K0)), O._bucket(max(1, I0))
    p = np.zeros((K, I_pad), np.int8)
    p[:K0, :I0] = np.asarray(frags.p).astype(np.int8)
    q = np.zeros((K, I_pad), np.uint8)
    q[:K0, :I0] = np.asarray(frags.baseq).astype(np.uint8)
    ds = frags.downsampled if apply_ds else np.ones(K0, bool)
    read_base = np.zeros(K, bool)
    read_base[:K0] = frags.for_phasing & ds
    site_mask = np.zeros(I_pad, bool)
    site_mask[:I0] = cands.for_phasing
    eta0 = np.ones(I_pad, np.int8)
    eta0[:I0] = O.init_genotype(cands)
    rng = np.random.default_rng(np.random.SeedSequence(
        [cfg.seed, seed & 0x7FFFFFFF]))
    sigma = np.where(rng.random((1 << I0, K)) < 0.5, np.int8(-1), np.int8(1))
    sigma[:, ~read_base] = 0
    O._first_member(torch.from_numpy(read_base & (sigma != 0)), 0)
    return {"cell_p": p, "cell_q": q, "read_base": read_base,
            "site_mask": site_mask, "eta": eta0, "sigma": sigma}


@functools.lru_cache(maxsize=None)
def _configs(I0: int, I_pad: int) -> np.ndarray:
    """The 2^I0 configurations in enumeration order, padded with +1 to
    I_pad: δ0 of each configuration's ascent (made once a process: at most
    max_enum_snps of them)."""
    c = np.pad(O.enumeration_order(I0), ((0, 0), (0, I_pad - I0)),
               constant_values=1).astype(np.int8)
    c.setflags(write=False)
    return c


class _Spec(NamedTuple):
    """A program input's shape and type, for ``_input_buffers``."""

    shape: tuple
    dtype: torch.dtype


def _upload(arrays: List[np.ndarray], device: torch.device
            ) -> List[torch.Tensor]:
    """``arrays`` (one dimension each, of 8-byte types before the others)
    on ``device`` in one copy from pinned memory, as one-dimensional
    tensors in order."""
    sizes = [a.nbytes for a in arrays]
    card = device.type == "cuda"
    packed = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=card)
    host = packed.numpy()
    at = 0
    for a, n in zip(arrays, sizes):
        host[at:at + n] = a.view(np.uint8)
        at += n
    on = packed.to(device, non_blocking=True) if card else packed
    # one view of each type's run of the bytes, then its arrays
    out, at, i = [], 0, 0
    while i < len(arrays):
        j = i
        while j < len(arrays) and arrays[j].dtype == arrays[i].dtype:
            j += 1
        n = sum(sizes[i:j])
        run = on[at:at + n].view(_TORCH_TYPE[arrays[i].dtype])
        out += run.split([a.size for a in arrays[i:j]])
        at, i = at + n, j
    return out


def _program(n: int, K: int, I_pad: int, dev: torch.device, fast: bool):
    """``make`` of the enumeration program for ``n`` configurations of a
    region of K reads and I_pad sites: the ascent of
    ``optimize._ascent_program`` for a chunk of the region's
    configurations, then the keep-best against the running best
    (best_prob, best_sigma, best_delta, best_eta); outputs the winner's σ,
    δ, η and objective."""
    def make():
        specs = dict(
            cell_p=_Spec((K, I_pad), torch.int8),
            cell_q=_Spec((K, I_pad), torch.uint8),
            read_base=_Spec((K,), torch.bool),
            site_mask=_Spec((I_pad,), torch.bool),
            conserved=_Spec((I_pad,), torch.bool),
            sigma=_Spec((n, K), torch.int8),
            delta=_Spec((n, I_pad), torch.int8),
            eta=_Spec((n, I_pad), torch.int8),
            best_sigma=_Spec((K,), f64), best_delta=_Spec((I_pad,), f64),
            best_eta=_Spec((I_pad,), f64), best_prob=_Spec((), f64))
        z, inputs, nodes = O._ascent_program(
            CompactCells, specs, dev, (n,), True, False, False, fast,
            dtypes=_WIDENED)
        z.win = O.PhaseState(*(torch.empty(m, dtype=f64, device=dev)
                               for m in (K, I_pad, I_pad)))
        z.win_prob = torch.empty((), dtype=f64, device=dev)
        z.win_index = torch.empty((), dtype=torch.int64, device=dev)

        def keep():
            KB.keep_best(z.prob, z.best_prob, TIE_TOL,
                         out=(z.win_prob, z.win_index))
            take = z.win_index >= 0
            at = z.win_index.clamp(min=0).reshape(1)
            for w, cur, prev in zip(z.win, z.cur, (z.best_sigma, z.best_delta,
                                                   z.best_eta)):
                w.copy_(torch.where(take, cur.index_select(0, at)[0], prev))

        return graphs.Program(dev, inputs,
                              nodes + (graphs.Piece("keep_best", keep),),
                              (*z.win, z.win_prob))
    return make


def phase_enum_wave(items: List[Tuple], cfg: CallerConfig,
                    device: torch.device) -> List[O.PhaseState]:
    """phase() of enumeration regions ``items`` ((frags, cands, seed,
    apply_ds) each, at most ``cfg.max_enum_snps`` candidates) in float64 on
    ``device``, every program launched before one host sync: their final
    states as host numpy, cut to true sizes, in order."""
    device = graphs._device_of(device)
    fast = O.USE_FAST_KERNELS
    with span("phase.enum_inputs"):
        regions = [_region_arrays(frags, cands, seed, apply_ds, cfg)
                   for frags, cands, seed, apply_ds in items]
        dims = [r["cell_p"].shape for r in regions]     # (K, I_pad) each
        I0s = [frags.p.shape[1] for frags, *_ in items]
        C = [1 << I0 for I0 in I0s]
        # each region's chunks of configurations: [(c0, n)]
        plan = [[(c0, min(chunk, c - c0)) for c0 in range(0, c, chunk)]
                for c, chunk in ((c, O.enum_chunk(c, K * I_pad))
                                 for c, (K, I_pad) in zip(C, dims))]
        configs = {I0: _configs(I0, I_pad)
                   for I0, (_, I_pad) in zip(I0s, dims)}
        # the results' slots: a region's running best before its chunks
        # (σ, δ, η, objective -inf), then each chunk's winner
        parts, starts, at = [], [], 0
        for (K, I_pad), chunks in zip(dims, plan):
            starts.append(at + K + 2 * I_pad)
            parts += [K, I_pad, I_pad, 1] * (1 + len(chunks))
            at += (1 + len(chunks)) * (K + 2 * I_pad + 1)
        results = np.zeros(at)
        results[starts] = -np.inf
        i8, u8, b8 = ("cell_p", "eta", "sigma"), ("cell_q",), ("read_base",
                                                              "site_mask")
        arrays = ([results]
                  + [r[k].reshape(-1) for r in regions for k in i8]
                  + [c.reshape(-1) for c in configs.values()]
                  + [r[k].reshape(-1) for r in regions for k in u8]
                  + [a for r in regions
                     for a in (*(r[k] for k in b8),
                               np.zeros(r["site_mask"].size, bool))])
    with span("phase.enum_upload"):
        on = iter(_upload(arrays, device))
        results = next(on)
        for r in regions:
            r.update(zip(i8, (next(on), next(on), next(on))))
        configs = {I0: next(on) for I0 in configs}
        for r in regions:
            r["cell_q"] = next(on)
        for r in regions:
            r.update(zip(b8 + ("conserved",), (next(on), next(on), next(on))))
        slots = iter(results.split(parts))
    with graphs.Launches(device) as launches, span("phase.enum_launches"):
        for r, (K, I_pad), chunks, I0 in zip(regions, dims, plan, I0s):
            cfgs = configs[I0]
            best = [next(slots) for _ in range(4)]
            for c0, n in chunks:
                values = dict(
                    cell_p=r["cell_p"], cell_q=r["cell_q"],
                    read_base=r["read_base"], site_mask=r["site_mask"],
                    conserved=r["conserved"],
                    sigma=r["sigma"][c0 * K:(c0 + n) * K],
                    delta=(cfgs if n * I_pad == cfgs.numel() else
                           cfgs[c0 * I_pad:(c0 + n) * I_pad]),
                    eta=r["eta"], best_sigma=best[0], best_delta=best[1],
                    best_eta=best[2], best_prob=best[3])
                best = [next(slots) for _ in range(4)]
                launches.run(("enum", fast, O.ASCENT_CHUNK),
                             _program(n, K, I_pad, device, fast), values,
                             best, key=(n, K, I_pad), capture=fast)
        flat = launches.read([results]).numpy()
    stage_add("phase_enum_wave_syncs", 1)
    at, out = 0, []
    for (frags, *_), (K, I_pad), chunks in zip(items, dims, plan):
        # the last chunk's winner is the region's
        at += len(chunks) * (K + 2 * I_pad + 1)
        K0, I0 = frags.p.shape
        out.append(O.PhaseState(flat[at:at + K0],
                                flat[at + K:at + K + I0],
                                flat[at + K + I_pad:at + K + I_pad + I0]))
        at += K + 2 * I_pad + 1
    stage_add("phase_enum_wave_regions", len(items))
    return out

"""The reads-sharded ascent over several cards of one process:

    python3 experiments/torch_giant_cards.py out.json

On a host with two or more cards: (1) one ascent of random cells
through sharded_cross_optimize over every card (reads_devices), with the
device programs on and off, against the first card repeated as often and
against as many CPU shards: bit-equal on the cards (the same partials in
the same order), the same decisions on the CPU, prob within 1e-9
relative; (2) the giant locus of chip_smoke.py (K 131,072 x I 512 padded
cells) through phase_region_sharded over every card and over the first
card repeated, programs on, and through phase_region with the routing of
an ordinary run (LONGCALLR_GIANT_CELLS at its default sends it to the
cards): equal states, walls and the group counters; (3) last, whether CUDA
takes a conditional WHILE node whose body holds work of a second card (the
error codes of composing and instantiating such a program)."""

import ctypes
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def _two_card_body(lib) -> dict:
    """A WHILE node on card 0 whose body is a child graph captured on card
    1: the error codes CUDA returns."""
    x = torch.zeros(1, device="cuda:1")
    with torch.cuda.device(1):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        side = torch.cuda.Stream(1)
        with torch.cuda.stream(side):
            g.capture_begin()
            x.add_(1)
            g.capture_end()
    flag = torch.zeros((), dtype=torch.bool, device="cuda:0")
    sets = torch.zeros(2, dtype=torch.int64, device="cuda:0")
    vp = ctypes.c_void_p
    graph, node, body, loop, handle = (vp(), vp(), vp(), vp(),
                                       ctypes.c_ulonglong())
    out = {"create": lib.gp_graph_create(0, ctypes.byref(graph))}
    out["handle"] = lib.gp_handle_create(graph, ctypes.byref(handle))
    out["set"] = lib.gp_add_set(graph, None, handle.value, flag.data_ptr(),
                                None, sets.data_ptr(), ctypes.byref(node))
    out["while"] = lib.gp_add_while(graph, node, handle.value,
                                    ctypes.byref(loop), ctypes.byref(body))
    child = vp()
    out["child_of_card_1"] = lib.gp_add_child(body, None, g.raw_cuda_graph(),
                                              ctypes.byref(child))
    exe = vp()
    out["instantiate"] = lib.gp_instantiate(graph, 0, ctypes.byref(exe))
    lib.gp_destroy(exe if out["instantiate"] == 0 else None, graph)
    torch.cuda.synchronize()
    return out


def main() -> int:
    from longcallr_tpu_torch import _build
    from longcallr_tpu_torch.parallel import giant, mesh as M
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G
    from longcallr_tpu_torch.phasing import optimize as O

    out = {"card": C._card(), "cards": torch.cuda.device_count()}
    lib = _build.load()
    cards = giant.reads_devices(torch.device("cuda", 0))
    if not cards:
        raise SystemExit("needs two or more cards")
    n = len(cards)

    r = np.random.default_rng(20261022)
    K, I = 8192, 256
    p8 = r.choice([-1, 0, 1], size=(K, I), p=[.3, .4, .3]).astype(np.int8)
    q8 = r.integers(3, 31, size=(K, I)).astype(np.uint8)
    rb = r.random(K) < .95
    args = (p8, q8, np.where(rb, np.where(r.random(K) < .5, -1., 1.), 0.),
            r.choice([-1., 1.], I), np.zeros(I), rb, r.random(I) < .95,
            r.random(I) < .2)
    res = {}
    for label, devs, on in (("cards", cards, True),
                            ("cards_off", cards, False),
                            ("card0", [cards[0]] * n, True),
                            ("cpu", [torch.device("cpu")] * n, True)):
        G.ENABLED = on
        try:
            CK.reset_launches()
            t0 = time.monotonic()
            res[label] = [t.cpu() for t in M.sharded_cross_optimize(
                devs, with_genotype=False, keep_conserved=True)(*args)]
            out[f"ascent_{label}"] = dict(
                seconds=time.monotonic() - t0, groups=dict(CK.GROUPS),
                flag_reads=CK.GRAPHS["flag_reads"])
        finally:
            G.ENABLED = True
    for label in ("cards_off", "card0"):
        if not all(torch.equal(a, b) for a, b in zip(res["cards"],
                                                      res[label])):
            raise AssertionError(f"ascent over the cards differs from "
                                 f"{label}")
    if not all(torch.equal(a, b) for a, b in zip(res["cards"][:3],
                                                  res["cpu"][:3])):
        raise AssertionError("ascent over the cards: decisions differ from "
                             "the CPU's")
    out["ascent_prob_rel_diff_cpu"] = abs(
        float(res["cards"][3]) / float(res["cpu"][3]) - 1)

    with tempfile.TemporaryDirectory() as tmp:
        locus = C._giant_locus(tmp, cards[0])
        cfg, reg, cands, frags, apply_ds = locus[:5]
        states, legs = {}, {}
        for label, devs in (("cards", cards), ("card0", [cards[0]] * n)):
            states[label], legs[label] = C._sharded_leg(
                f"giant locus {label}", locus, devs, True)
        C._states_equal("giant locus, the cards against card 0 repeated",
                        states["cards"], states["card0"])
        CK.reset_launches()
        t0 = time.monotonic()
        routed = O.phase_region(frags, cands, cfg, reg.start, apply_ds,
                                device=cards[0])
        torch.cuda.synchronize()
        legs["phase_region_routed"] = dict(
            wall_seconds=time.monotonic() - t0, groups=dict(CK.GROUPS),
            flag_reads=CK.GRAPHS["flag_reads"])
        if not CK.GROUPS["launches"]:
            raise AssertionError("phase_region did not take the cards")
        C._states_equal("giant locus routed by phase_region",
                        (a[:len(b)] for a, b in zip(states["cards"],
                                                    routed)), routed)
        out["giant_locus"] = dict(region=str(reg), K=int(frags.p.shape[0]),
                                  snps=int(frags.p.shape[1]), legs=legs)
    print(json.dumps(out, default=str), flush=True)
    # last: the refused compositions leave errors in the library's runtime
    out["two_card_body"] = _two_card_body(lib)
    print(json.dumps(out["two_card_body"]))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())

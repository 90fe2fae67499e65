#!/usr/bin/env python3
"""How often ``torch.profiler``'s trace of an engine's decode window misses
kernels of its CUDA-graph replays.

    python3 scripts/trace_loss.py [windows]        (default 120; needs a card)

The window is ``chip_smoke.py``'s phase 2 one that once lost a replay's
kernels: the ``deepseek_smoke`` engine after ``launch.serve``'s traffic, a
fresh batch of 8 rows on the live adapters, 16 width-1 steps through
``run_steps`` (a graph replay a step).  Each window runs in two arms,
alternating: with the run right at the profiler's start and stop, and
with a synchronize and ``chip_smoke.TRACE_MARGIN_S`` of idle inside the
profiler before and after the run, as ``chip_smoke.profile_window`` does
(records near the edges of the profiler's capture window can be lost).
For each, the launch counters' rise against the port's kernels in the
trace (by ``chip_smoke.wrapper_of``) and against what the calls' replays
ran by the trace (``chip_smoke.replay_launches``: the fullest traced
replay's kernels a call), and which replays (0 the first) carry fewer
device events than the fullest.  Prints a summary an arm and writes every
window to ``chiprun_out/trace_loss.json``.
"""
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

STEPS = 16


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build, ops
    from repro_torch.launch.serve import serve
    from repro_torch.serve.engine import SamplingParams

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    t0 = time.perf_counter()
    build.build_all(("bgmv", "mla_ring_decode"))
    out = serve("deepseek_smoke", device="cuda", log=lambda s: None)
    eng = out["engine"]
    live = [i for i in sorted(set(out["served_by"].values()))
            if i and eng.registry.is_live(i)]

    def window(margin: bool) -> dict:
        eng.run()
        for i in range(eng.B):
            eng.submit(list(range(1 + i, 17 + i)),
                       SamplingParams(max_tokens=STEPS + 4),
                       adapter_id=live[i % len(live)])
        eng.run_steps(1 + -(-16 // eng.chunk))
        calls0 = len(eng.step_log())
        counted0 = ops.launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if margin:
                torch.cuda.synchronize()
                time.sleep(cs.TRACE_MARGIN_S)
            eng.run_steps(STEPS, 1)
            torch.cuda.synchronize()
            if margin:
                time.sleep(cs.TRACE_MARGIN_S)
        counted = ops.launch_delta(counted0, ops.launch_counts())
        made = [(s["width"], s["burst"]) for s in eng.step_log()[calls0:]]
        events = sorted(prof.events(), key=lambda e: e.time_range.start)
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        launches = [e.id for e in events if e.device_type == DeviceType.CPU
                    and e.name == "cudaGraphLaunch"]
        kernels = [(e.id, w) for e in device if (w := cs.wrapper_of(e.name))]
        traced = dict(Counter(w for _, w in kernels))
        by_replay, short = cs.replay_launches(made, launches, kernels)
        per = [sum(e.id == cid for e in device) for cid in launches]
        return {"margin": margin, "counted": counted, "traced": traced,
                "agree": counted == traced, "by_replay": by_replay,
                "agree_by_replay": counted == by_replay,
                "replays_short_of_port_kernels": short,
                "graph_launches": len(launches), "device_events": len(device),
                "short_replays": [i for i, c in enumerate(per)
                                  if c < max(per, default=0)]}

    recs = []
    for k in range(n):
        for margin in (False, True):
            r = window(margin)
            recs.append(r)
            if not r["agree"] or r["short_replays"]:
                print("lost:", json.dumps(r), flush=True)
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}; "
          f"{time.perf_counter() - t0:.1f} s")
    for margin in (False, True):
        rs = [r for r in recs if r["margin"] == margin]
        print(f"{'with' if margin else 'without'} the "
              f"{cs.TRACE_MARGIN_S * 1e3:g} ms margins: "
              f"{sum(not r['agree'] for r in rs)} of {len(rs)} windows' traces "
              f"disagree with the counters, {sum(bool(r['short_replays']) for r in rs)} "
              f"have a short replay, {sum(not r['agree_by_replay'] for r in rs)} "
              f"disagree by replay; device events a window "
              f"{sorted({r['device_events'] for r in rs})}")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "trace_loss.json").write_text(json.dumps(recs))


if __name__ == "__main__":
    main()

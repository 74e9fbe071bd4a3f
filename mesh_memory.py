#!/usr/bin/env python3
"""Where the peak device memory of the mesh train step goes, on one CUDA
card.

  python3 mesh_memory.py [--steps N]

In a process group of one rank over NCCL (a ``HashStore``: no network) it
trains smollm-360M whole (bf16, 8 x 512, as ``chip_smoke.py`` phases 13 and
31) through ``launch.train.train``, data-parallel and ZeRO-3
(``force_fsdp``), eager and graphed, under two process groups in turn: as
NCCL is set up by default, and with ``TORCH_NCCL_AVOID_RECORD_STREAMS=1``
(the process group then keeps a collective's tensors until the collective
ends, instead of recording them on its stream for the allocator). For each
run it reads ``torch.cuda.max_memory_allocated``. For the ZeRO-3 runs it
also records the allocator's history
(``torch.cuda.memory._record_memory_history``, Python stacks), replays it
to the moment the most bytes were allocated, and sums the blocks allocated
then by the line of ``repro_torch`` that asked for them (the innermost
frame there; none for the backward's C++ allocations). It sums apart the
blocks the program had freed but the allocator had not yet taken back
(a block used on another stream waits for that stream; under capture it
waits for the capture's end).

Prints the card's name and power limit (``nvidia-smi``), one line per run
and a JSON summary last; writes the report to
``chiprun_out/mesh_memory.json``. Exits non-zero without a CUDA device or
when a run fails.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOP = 8


def frame_key(frames) -> str:
    """file:line function of the innermost ``repro_torch`` frame."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            rel = name[name.index("repro_torch"):]
            return f"{rel}:{f.get('line')} {f.get('name')}"
    return "(no repro_torch frame: the backward's C++ allocations)"


def peak_breakdown(snapshot, device: int = 0) -> dict:
    """The allocated bytes at the trace's peak, by allocating line: live
    blocks and blocks freed by the program but not yet taken back."""
    events = snapshot["device_traces"][device]

    def replay(stop=None):
        live, cur, peak, at = {}, 0, 0, -1
        for i, e in enumerate(events[:stop]):
            a, addr = e["action"], e.get("addr")
            if a == "alloc":
                live[addr] = [e["size"], e.get("frames", []), False]
                cur += e["size"]
                if cur > peak:
                    peak, at = cur, i
            elif a == "free_requested" and addr in live:
                live[addr][2] = True
            elif a == "free_completed" and addr in live:
                cur -= live.pop(addr)[0]
        return live, peak, at

    _, peak, at = replay()
    live, _, _ = replay(at + 1)
    by = {False: collections.Counter(), True: collections.Counter()}
    for size, frames, freed in live.values():
        by[freed][frame_key(frames)] += size
    return {"events": len(events), "peak_event": at, "peak_bytes": peak,
            "live_bytes": sum(by[False].values()),
            "freed_not_taken_back_bytes": sum(by[True].values()),
            "live_top": by[False].most_common(TOP),
            "freed_not_taken_back_top": by[True].most_common(TOP)}


def child(steps: int) -> list:
    """This process's runs, under the process group its environment sets
    up."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.train import train

    avoid = os.environ.get("TORCH_NCCL_AVOID_RECORD_STREAMS") == "1"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    runs, gib = [], 2 ** 30
    try:
        for label, over in (("data_parallel", {}),
                            ("zero3", {"force_fsdp": True})):
            for graphs in (False, True):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                trace = label == "zero3"
                if trace:
                    torch.cuda.memory._record_memory_history(
                        stacks="python", max_entries=2_000_000)
                out = train("smollm_360m", smoke=False, steps=steps, batch=8,
                            seq=512, device="cuda", graphs=graphs,
                            overrides=over, log_every=steps)
                run = {"avoid_record_streams": avoid, "run": label,
                       "graphed": graphs,
                       "max_memory_allocated": torch.cuda.max_memory_allocated(),
                       "losses": out["losses"]}
                del out
                if trace:
                    snap = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(None)
                    run["trace"] = peak_breakdown(snap)
                    del snap
                runs.append(run)
                line = (f"[mesh_memory] avoid_record_streams={int(avoid)} "
                        f"{label} {'graphed' if graphs else 'eager'}: peak "
                        f"{run['max_memory_allocated'] / gib} GiB")
                if trace:
                    t = run["trace"]
                    line += (f"; trace peak {t['peak_bytes'] / gib} GiB = live "
                             f"{t['live_bytes'] / gib} + freed, not taken back "
                             f"{t['freed_not_taken_back_bytes'] / gib}; live: "
                             + "; ".join(f"{k} {v / gib:.3f}"
                                         for k, v in t["live_top"][:4])
                             + "; freed: " + "; ".join(
                                 f"{k} {v / gib:.3f}" for k, v in
                                 t["freed_not_taken_back_top"][:4]))
                print(line, flush=True)
    finally:
        dist.destroy_process_group()
    return runs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_memory: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        Path(args.child).write_text(json.dumps(child(args.steps)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = {"device": torch.cuda.get_device_name(0), "card": card,
              "steps": args.steps, "runs": []}
    for avoid in ("0", "1"):
        part = out_dir / f"mesh_memory_{avoid}.json"
        env = dict(os.environ, TORCH_NCCL_AVOID_RECORD_STREAMS=avoid)
        rc = subprocess.run([sys.executable, __file__, "--steps",
                             str(args.steps), "--child", str(part)],
                            env=env).returncode
        if rc:
            print(f"mesh_memory: the run with TORCH_NCCL_AVOID_RECORD_STREAMS="
                  f"{avoid} failed ({rc})", file=sys.stderr)
            return 1
        report["runs"] += json.loads(part.read_text())
        part.unlink()
    (out_dir / "mesh_memory.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"device": report["device"], "peak_bytes": {
        f"avoid={int(r['avoid_record_streams'])} {r['run']} "
        f"{'graphed' if r['graphed'] else 'eager'}": r["max_memory_allocated"]
        for r in report["runs"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

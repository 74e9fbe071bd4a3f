#!/usr/bin/env python3
"""Time the selective scan's backward of this checkout against another
checkout's on one CUDA card, each held to the plain backward.

  python3 scan_bwd_compare.py --parent DIR

DIR is the root of the other checkout, for example the parent commit
unpacked by ``git archive`` into ``build/parent``. Each checkout's kernels
are built by its own ``repro_torch.kernels._build`` (into its own
``build/kernels``) and run in a process of their own, in the order parent,
this, this, parent, so that a drift of the card's clock over the call
shows. Each process, at Jamba's training shape (u 8 x 512 x 16384 bf16, dt
float32, N 16, B and C column slices of one projection, no dh_T), with a
random A and with Mamba's initial A:
  - runs the training forward and the backward (both launches) and holds
    the gradients to the plain backward (float32 ones as gradient leaves,
    1e-4 max|g| + 1e-6; bf16 du, dB, dC per element to 2^-7 |plain| +
    2^-5 rms(plain)), and two calls bit for bit;
  - times the backward over ROUNDS x CALLS back-to-back calls with CUDA
    events (the median round) and reads the SM clock while it runs.
Prints one line per process and a JSON report last; writes it to
``chiprun_out/scan_bwd_compare.json``. Exits non-zero when a process fails
or a checkout's gradients are outside their limits.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3
CALLS = 10
SHAPE = (8, 512, 16384, 16)


def held(got, want) -> float:
    """The worst error over its limit among the seven gradients."""
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        wf, err = w.float(), (g.float() - w.float()).abs()
        if w.dtype == torch.bfloat16:
            limit = 2.0 ** -7 * wf.abs() + 2.0 ** -5 * wf.square().mean().sqrt()
        else:
            limit = torch.full_like(wf, 1e-4 * float(wf.abs().max()) + 1e-6)
        worst = max(worst, float((err / limit).max()))
    return worst


def sm_clock_mhz(fn, seconds: float = 0.5):
    """The median SM clock nvidia-smi reads while ``fn`` runs in a loop."""
    import torch
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "20"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    mhz = [float(v) for v in out.split() if v.replace(".", "").isdigit()]
    return statistics.median(mhz) if mhz else None


def child(root: Path) -> dict:
    """Time and check the backward of the checkout at ``root``."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import mamba_scan as ms

    bt, t, d_in, n = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {"root": str(root), "cases": {}}
    for case, mamba_a in (("random A", False), ("Mamba's A", True)):
        u, dt = randn((bt, t, d_in)), F.softplus(randn((bt, t, d_in), torch.float32))
        proj = randn((bt, t, 512 + 2 * n))
        B, C = proj[..., 512:512 + n], proj[..., 512 + n:]
        A = (-torch.arange(1, n + 1, device="cuda", dtype=torch.float32).repeat(d_in, 1)
             if mamba_a else -torch.exp(randn((d_in, n), torch.float32)))
        D, dy = randn((d_in,), torch.float32), randn((bt, t, d_in))
        hs = ms.mamba_scan_train_cuda(u, dt, A, B, C, D)[2]
        args = (u, dt, A, B, C, D, hs, dy, None)
        got, again = ms.mamba_scan_bwd_cuda(*args), ms.mamba_scan_bwd_cuda(*args)
        want = ms.mamba_scan_bwd_plain(u, dt, A, B, C, D, dy)
        torch.cuda.synchronize()
        rec = out["cases"][case] = {
            "worst_err_over_limit": held(got, want),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(got, again))}
        del got, again, want
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        times = []
        for _ in range(ROUNDS):
            start.record()
            for _ in range(CALLS):
                ms.mamba_scan_bwd_cuda(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / CALLS)
        rec["bwd_ms"], rec["bwd_ms_all"] = statistics.median(times), times
        rec["sm_clock_mhz"] = sm_clock_mhz(lambda: ms.mamba_scan_bwd_cuda(*args))
        del u, dt, proj, B, C, A, D, dy, hs, args
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve())), flush=True)
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    parent = args.parent.resolve()
    runs, ok = [], True
    for name, root in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               str(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["name"] = name
        runs.append(rec)
        for case, c in rec["cases"].items():
            ok = ok and c["worst_err_over_limit"] <= 1.0 and c["bit_equal"]
            print(f"[{name}] {case}: backward {c['bwd_ms']:.4f} ms "
                  f"({', '.join(f'{v:.4f}' for v in c['bwd_ms_all'])}), SM clock "
                  f"{c['sm_clock_mhz']} MHz; worst {c['worst_err_over_limit']:.3f} of its "
                  f"limit, two calls bit-equal {c['bit_equal']}", flush=True)
    report = {"card": card, "shape": SHAPE, "runs": runs, "ok": ok}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "scan_bwd_compare.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

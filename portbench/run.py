"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s`` from the process start): the scene and the
replicas' thermal velocities from the seed, the program's force field,
replica batch and runner from the configuration, one warm chunk at the
cell's shapes (every kernel built and loaded). The window then runs
chunks of the traffic's length for ``--seconds`` (closed loop: the next
chunk starts when the last has come back to the host); ``ns_per_day`` is
every replica-step of the window at the configuration's fixed dt over the
window's whole wall time. With ``--trace 1`` the window runs as it does
untraced, then ``TRACE_CHUNKS`` more chunks run under ``torch.profiler``,
and the per-layer metrics are read from the window and the trace
instead. Then the program is freed and the float64 reference judges what
the last chunk produced (``harness/check.py``). Standard error logs the
set-up's phases and each chunk's wall time. The last line of standard
output is the result; the compared numbers and their limits end standard
error and the result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cavmd_tpu")
TRACE_CHUNKS = 2
FS_PER_NS = 1e6
SECONDS_PER_DAY = 86400.0


class Device:
    """Synchronisation and memory readings of the run's device (the CPU
    tests run the same code on the CPU, where these are no-ops)."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def info(self) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        return {"platform": "gpu",
                "kind": self.torch.cuda.get_device_name(0), "count": 1}


class Context:
    """What a per-layer metric reader sees of the run."""


class Phases:
    """Wall-clock marks of the set-up's phases, from the process start."""

    def __init__(self, t0: float):
        self.last = t0
        self.marks = []

    def mark(self, name: str):
        now = time.perf_counter()
        self.marks.append((name, now - self.last))
        self.last = now

    def text(self) -> str:
        return ", ".join(f"{k} {v:.3f}" for k, v in self.marks)


def load_text() -> str:
    """The host's load averages (1, 5, 15 min) and the CPUs this process
    may use: what else the host was doing beside the run."""
    import os

    try:
        load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    except OSError:
        load = "n/a"
    return f"{load} on {len(os.sched_getaffinity(0))} cpus"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, lim: dict, program_class=None, control=False,
             log=sys.stderr, phases=None):
    """Set up, run the window, read the metrics and judge the outputs.
    Returns the result dict (without the forbidden-module check).
    ``program_class`` stands in for ``harness.program.Program`` (the
    tests break the timed path through it); with ``control`` the
    reference in bfloat16 is judged too, put in the program's place on
    the same stretch (``result["control"]``). ``phases`` holds the marks
    of the process's start, if any."""
    import torch

    from portbench.harness import check, program, scene as scene_mod
    from portbench.harness.cells import load_metric

    dev = Device(torch, device)
    cfg, traffic = cell.config, cell.traffic
    B = int(traffic["replicas"])
    chunk = int(traffic["chunk_steps"])
    phases = phases or Phases(t0)
    phases.mark("harness")
    scene = scene_mod.make_scene(cfg, seed)
    vel = scene_mod.thermal_velocities(cfg, scene, B, seed, dev.device)
    phases.mark("scene")
    cls = program_class or program.Program
    prog = cls(cfg, scene, vel, B, seed, dev.device)
    f0 = prog.state.forces[0].clone()
    dev.sync()
    phases.mark("program")
    prof = None
    if trace:
        from portbench.harness.trace import Profiler

        prof = Profiler(torch)
        prof.warm()
    for _ in range(int(traffic.get("warm_chunks", 1))):
        prog.run_chunk(chunk)
    dev.sync()
    phases.mark("warm")
    setup_peak = dev.peak()
    prog.replans = 0
    setup_s = time.perf_counter() - t0

    dev.reset_peak()
    steps = chunks = failed = 0
    times = []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds or not chunks:
        c0 = time.perf_counter()
        start, rng, obs, retried = prog.run_chunk(chunk)
        times.append(time.perf_counter() - c0)
        steps += chunk
        chunks += 1
        failed += B if retried else 0
    dev.sync()
    window_s = time.perf_counter() - w0
    window_peak = dev.peak()
    replans = prog.replans
    dt_fs = float(cfg["physics"]["dt_fs"])
    result = {"correct": False, "attempted": B * chunks, "failed": failed}
    metrics = {}
    info = dev.info()
    info["memory_peak_bytes"] = max(setup_peak, window_peak)
    print(f"set-up {setup_s:.3f} s: {phases.text()}", file=log, flush=True)
    print(f"window: {chunks} chunks, {steps} steps of {B} replicas in "
          f"{window_s:.3f} s; re-plans {replans} ({prog.plan_text()}); "
          f"chunk s: {' '.join(f'{t:.3f}' for t in times)}; load "
          f"{load_text()}", file=log, flush=True)
    tr = None
    if prof is not None:
        from portbench.harness.trace import Trace

        prof.start()
        tr0 = time.perf_counter()
        for _ in range(TRACE_CHUNKS):
            start, rng, obs, _retried = prog.run_chunk(chunk)
        dev.sync()
        traced_s = time.perf_counter() - tr0  # without the tracer's stop
        dev_rec, host_rec = prof.stop()
        tr = Trace(dev_rec, host_rec, TRACE_CHUNKS * chunk, traced_s)
    rows = check.followed_rows(seed, B)
    cap = check.Capture(start, rng, prog.state, obs, rows, f0,
                        (program.BUSSI_STREAM, program.LANGEVIN_STREAM))
    if not trace:
        metrics["ns_per_day"] = {
            "value": B * steps * dt_fs / FS_PER_NS / window_s
            * SECONDS_PER_DAY, "unit": "ns/day"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = Context()
        ctx.torch, ctx.cfg, ctx.scene = torch, cfg, scene
        ctx.replicas, ctx.trace, ctx.program = B, tr, prog
        ctx.window_s, ctx.window_steps = window_s, steps
        ctx.window_peak, ctx.replans = window_peak, replans
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
        del ctx, tr
    result["metrics"] = metrics
    result["device"] = info

    del prog, start, rng, obs
    if dev.cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    judge = check.Judge(cfg, scene, dev.device)
    numbers = judge.numbers(check.program_outputs(cap), cap)
    ok, table = check.verdict(numbers, lim)
    print(f"check: {time.perf_counter() - c0:.3f} s", file=log, flush=True)
    for k, (v, m) in table.items():
        print(f"{k} {v!r} limit {m!r}", file=log, flush=True)
    result["correct"] = ok
    if control:
        out = check.control_outputs(cfg, scene, cap, dev.device)
        result["control"] = judge.numbers(out, cap)
    result["checks"] = {k: {"value": v, "limit": m}
                        for k, (v, m) in table.items()}
    return result


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    phases = Phases(T0)
    sys.path.insert(0, str(ROOT))
    from portbench.harness.cells import Cell
    from portbench.harness.check import limits

    cell = Cell(args.workload)
    import torch

    phases.mark("torch")
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    phases.mark("cuda_init")
    import cavmd_tpu_torch

    phases.mark("package")

    where = Path(cavmd_tpu_torch.__file__).resolve()
    if ROOT not in where.parents:
        print(f"portbench: cavmd_tpu_torch comes from {where}, not from "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0, limits(args.workload), phases=phases)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

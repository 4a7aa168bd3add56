"""What the wrapper A/B scripts share: the host time of one kernel's
wrappers in two trees of the port, on the card, one process per tree.

Used by ``examples/scs_wrapper_ab.py``, ``examples/dia_wrapper_ab.py`` and
``examples/coo_wrapper_ab.py``.
Each tree is the root of a checkout of this repo, for example an older
commit unpacked with ``git archive`` under the gitignored ``build/``. Each
tree runs in a process of its own, which imports that tree's
``repro_torch`` (its kernels build into the tree's own ``build/``), builds
the calls the script names, and then waits. Both processes stay up, and
the rounds alternate between them (old, new, then new, old), so drift of
the shared host lands on both alike. In a round a process makes each call
and reports:

  - ``call_us``: host wall time per call over 200 calls in a row with no
    synchronisation between them: what the wrapper costs the host while
    the card keeps up;
  - ``ms``: median of CUDA events around one call, as ``chip_smoke.py``
    reads ``ms`` (the wrapper's host time shows in it when the kernel is
    shorter);
  - ``kernel_ms``: the kernel's device time alone, from ``torch.profiler``.

The kernels are the trees' own, so ``ms`` minus ``kernel_ms`` is the host
share each tree's wrapper adds to ``ms``. Prints every round and then, per
tree, the median of each number with its lower and upper quartile over the
rounds: a change shows where its quartiles and the other tree's do not
overlap. Compare trees only within one run. Needs a CUDA card and nvcc.
"""
import json
import os
import subprocess
import sys
import time

ROUNDS, CALLS, REPS = 20, 200, 50


def serve(tree, make_calls, kernel):
    """Serve rounds for one tree: a line ``go`` on stdin runs one round and
    prints its times as one JSON line; end of input ends the process.
    ``make_calls(device)`` returns ``{label: fn}`` built with the tree's
    ``repro_torch``; ``kernel`` is a part of the kernel's name, or a tuple
    of parts of the names of the kernels to count (a yardstick call's
    too)."""
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    parts = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    calls = make_calls(torch.device("cuda"))
    for fn in calls.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    print("ready", flush=True)
    for _ in sys.stdin:
        out = {}
        for label, fn in calls.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            call_us = (time.perf_counter() - t0) / CALLS * 1e6
            torch.cuda.synchronize()
            ms = []
            for _ in range(REPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            dev_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                         if e.device_type != DeviceType.CPU
                         and any(k in e.key for k in parts))
            out[label] = dict(call_us=call_us, ms=sorted(ms)[REPS // 2],
                              kernel_ms=dev_us / 20 / 1e3)
        print(json.dumps(out), flush=True)


def compare(script, old, new):
    """Start one process per tree running ``script --one TREE`` and time
    them in alternating rounds."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    procs = {}
    for tree in (old, new):
        procs[tree] = subprocess.Popen(
            [sys.executable, os.path.abspath(script), "--one", tree], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, bufsize=1)

    def reply(tree):
        for line in procs[tree].stdout:
            if line.startswith(("ready", "{")):
                return line
        raise SystemExit(f"{tree}: the process ended early")

    try:
        for tree in procs:
            reply(tree)
        runs = {old: [], new: []}
        for rnd in range(ROUNDS):
            for tree in ((old, new) if rnd % 2 == 0 else (new, old)):
                procs[tree].stdin.write("go\n")
                procs[tree].stdin.flush()
                rec = json.loads(reply(tree))
                print(f"round {rnd} {tree}: {json.dumps(rec)}", flush=True)
                runs[tree].append(rec)
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=60)
    for tree, recs in runs.items():
        n = len(recs)
        for label in recs[0]:
            q = {k: sorted(r[label][k] for r in recs) for k in recs[0][label]}
            print(f"{label} {tree}: median [quartiles] of {n} rounds: "
                  + " ".join(f"{k}={v[n // 2]} [{v[n // 4]}, {v[3 * n // 4]}]"
                             for k, v in q.items()))


def run(script, make_calls, kernel, doc):
    """The command line of a wrapper A/B script: ``OLD_TREE NEW_TREE``, or
    ``--one TREE`` in the process of one tree."""
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        serve(sys.argv[2], make_calls, kernel)
    elif len(sys.argv) == 3:
        compare(script, sys.argv[1], sys.argv[2])
    else:
        raise SystemExit(doc)

"""Chaos serving demo of the PyTorch port, as ``examples/chaos_serve.py``:
kill the cuda lane mid-traffic, watch it recover.

  PYTHONPATH=src python examples/chaos_serve_torch.py [--device cpu]

A seeded `FaultPlan` injects a burst of kernel failures into the engine's
preferred (cuda: the hand-written kernels) backend while requests are in
flight. The timeline printed below is the whole resilience story:

  1. healthy serving on the cuda lane
  2. injected failures trip the per-DispatchKey circuit breaker -> the
     csr/cuda cell is quarantined
  3. while the breaker's cooldown runs, flushes serve the *degraded* lane
     (plain) — rerouted, bit-identical, still 100% success
  4. the cooldown elapses; the next dispatch is the probe, it succeeds,
     and the cuda lane recovers

Every request in every phase resolves ok. Runs on the card unless
``--device cpu``.
"""
import argparse
import time

import numpy as np

from repro_torch.core import ExecutionPolicy
from repro_torch.core import matrices as M
from repro_torch.core.health import HealthRegistry
from repro_torch.resilience import FaultPlan, FaultSpec
from repro_torch.serve import ServeEngine

COOLDOWN_S = 0.4
N = 256

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="where the engine serves (default cuda)")
device = ap.parse_args().device
rng = np.random.default_rng(0)
A = (M.banded(N, 3, seed=0) + M.random_uniform(N, 0.02, seed=1)).tocsr()

t0 = time.perf_counter()


def stamp() -> str:
    return f"t={time.perf_counter() - t0:6.3f}s"


engine = ServeEngine(policy=ExecutionPolicy.for_impl("cuda"), fmt="csr",
                     tune_mode=None, capacity=4, max_batch=8,
                     check_finite=True, max_retries=1, device=device,
                     health=HealthRegistry(cooldown_s=COOLDOWN_S,
                                           clock=time.perf_counter))


def serve_batch(tag: str, k: int = 4) -> None:
    tickets = [engine.submit(A, rng.standard_normal(N).astype(np.float32))
               for _ in range(k)]
    engine.flush()
    ok = sum(t.ok for t in tickets)
    degraded = sum(bool(t.record and t.record.degraded) for t in tickets)
    lane = "degraded(plain)" if degraded else "cuda"
    print(f"  {stamp()}  {tag}: {ok}/{k} ok, lane={lane}")


print("== 1. healthy traffic on the cuda lane ==")
for i in range(2):
    serve_batch(f"batch {i}")

print("\n== 2. fault plan armed: the next 2 cuda dispatches raise ==")
# each flush coalesces into one SpMM tile = one dispatch, so two flushes
# under the plan are the two consecutive failures that trip the breaker
plan = FaultPlan([FaultSpec(site="kernel", key="cuda", times=2)], seed=0)
with plan:
    serve_batch("batch 2 (under faults)")
    serve_batch("batch 3 (under faults)")
print(f"  {stamp()}  injected: {plan.events}")
print(f"  {stamp()}  quarantined now: "
      f"{engine.health.snapshot()['quarantined_now']}")

print("\n== 3. degraded serving while the breaker cooldown runs ==")
serve_batch("batch 4")
serve_batch("batch 5")

print(f"\n== 4. cooldown ({COOLDOWN_S}s) elapses -> probe -> recovery ==")
time.sleep(COOLDOWN_S)
serve_batch("batch 6 (probe)")
snap = engine.health.snapshot()
print(f"  {stamp()}  probes={snap['probes']} recoveries={snap['recoveries']} "
      f"quarantined_now={snap['quarantined_now']}")

print("\n== breaker event timeline ==")
for event, key, t in engine.health.events:
    print(f"  t={t - t0:6.3f}s  {event:12s} {key}")

out = engine.summary()
print(f"\navailability={out['availability']:.0%} "
      f"served={out['requests']} errors={out['errors']} "
      f"degraded={out['degraded_requests']} retries={out['retries']}")
assert out["availability"] == 1.0 and not snap["quarantined_now"]
print("every request served; cuda lane recovered.")

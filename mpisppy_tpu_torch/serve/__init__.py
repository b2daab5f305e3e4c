"""mpisppy_tpu_torch.serve — the persistent stochastic-program serving
layer (the port of the JAX package's serve/).

The batch CLI (``python -m mpisppy_tpu_torch <model>``) pays the engine
build, the factorizations and the kernel plans on every invocation and
dies with its wheel. This package is the service plane over the same
engine: one long-lived process (``python -m mpisppy_tpu_torch serve
--port N --state-dir D``) that

- fingerprints requests into **shape buckets** and keeps one warm
  engine (+ kernel plans + KKT factorizations) per bucket with LRU
  eviction (:mod:`.cache`) — the second request of a shape builds no
  kernel and sets up no factorization,
- admits requests through a bounded queue with per-request deadlines
  wired to the hub's ``wheel_deadline`` watchdog (:mod:`.queue`),
- **coalesces data-only instances of one bucket into a single stacked
  wheel along the scenario axis** (:mod:`.batch`): each request gets
  its own stage-1 tree root, so consensus never couples tenants and
  one kernel launch serves the whole group,
- runs N concurrent wheels with durable per-request ``ckpt/`` bundles
  as the request-state store (:mod:`.manager`): a preempted (SIGTERM)
  or killed request resumes through the ``--resume-from`` machinery
  instead of failing, and results outlive the connection,
- serves ``POST /solve`` / ``GET /result/<id>`` / ``GET /queue`` plus
  the live plane's ``/metrics`` + ``/status`` (:mod:`.http`), and
  **rolling-horizon chains** as a first-class request type (solve a
  horizon, commit the head, roll forward warm-started from the previous
  bundle),
- hands live work to a peer service on drain or SIGTERM
  (:mod:`.migrate`; the wire protocol is the JAX package's, byte for
  byte, so services of either package hand work to each other).

Layering: the HTTP/queue/cache/batch/migrate plane imports stdlib,
numpy and the ``ir/`` host layer only — only :mod:`.manager` (the wheel
runner) touches the engine and torch.
"""

from __future__ import annotations

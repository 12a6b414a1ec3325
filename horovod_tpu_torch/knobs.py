"""Canonical registry of every environment knob the port reads.

``ENV_KNOBS`` is the port's own table, the counterpart of
``horovod_tpu/knobs.py``: one ``(name, default, help)`` row per knob.
Knobs that Horovod users set keep Horovod's names (``HOROVOD_*``, and the
launcher's ``HOROVOD_TPU_*`` rendezvous variables); the port's own are
``HVD_TORCH_*``, with the reference's defaults.  Every knob literal in
``horovod_tpu_torch/`` must have a row here and every row must be read
somewhere (``tests/test_torch_knobs.py`` scans the package's AST).

The table stays a pure literal.  Keep rows sorted by name; an empty
default means "unset" (the reader treats absence and empty string the
same).  ``python -m horovod_tpu_torch.knobs`` prints it as a Markdown
table.
"""

from __future__ import annotations

import collections

# name, default (as the env string; "" = unset), one-line help.
ENV_KNOBS = (
    ("HOROVOD_AUTOTUNE", "0",
     "Enable online (fusion-threshold, cycle-time) autotuning."),
    ("HOROVOD_AUTOTUNE_LOG", "",
     "CSV file receiving one row per autotune sample."),
    ("HOROVOD_AUTOTUNE_STEADY_STATE_SAMPLES", "10",
     "Samples per tuning point after warmup before scoring it."),
    ("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "3",
     "Samples discarded after each knob change before measuring."),
    ("HOROVOD_CYCLE_TIME", "5.0",
     "Background dispatch-loop cycle time in milliseconds."),
    ("HOROVOD_FUSION_THRESHOLD", "67108864",
     "Tensor-fusion bucket size in bytes (64 MiB default)."),
    ("HOROVOD_HIERARCHICAL_ALLREDUCE", "0",
     "Two-level allreduce: reduce-scatter in the node, allreduce across "
     "nodes, allgather in the node (node = local_size ranks)."),
    ("HOROVOD_STALL_CHECK_DISABLE", "0",
     "Disable the stalled-negotiation warning thread."),
    ("HOROVOD_STALL_CHECK_TIME", "60.0",
     "Seconds a rank may lag negotiation before a stall warning."),
    ("HOROVOD_TIMELINE", "",
     "Chrome-trace timeline output path (enables timeline recording)."),
    ("HOROVOD_TPU_COORDINATOR", "",
     "host:port of the rank-0 coordinator for multi-process init."),
    ("HOROVOD_TPU_LOCAL_RANK", "",
     "This process's rank within its host (launcher-provided)."),
    ("HOROVOD_TPU_LOCAL_SIZE", "",
     "Number of processes on this host (launcher-provided)."),
    ("HOROVOD_TPU_NUM_PROCESSES", "",
     "World size for multi-process init (unset = single process)."),
    ("HOROVOD_TPU_PROCESS_ID", "",
     "This process's global rank (launcher-provided)."),
    ("HVD_TORCH_ALERTS", "1",
     "Evaluate ALERT_RULES over the sampled series (0 = off)."),
    ("HVD_TORCH_AUTOSCALE", "0",
     "Actuate CapacityAdvisor recommendations from the router poller."),
    ("HVD_TORCH_AUTOSCALE_COOLDOWN_S", "30",
     "Seconds the autoscaler rests between actuations."),
    ("HVD_TORCH_AUTOSCALE_MAX_REPLICAS", "8",
     "Fleet size ceiling the autoscaler will not grow past."),
    ("HVD_TORCH_AUTOSCALE_MIN_REPLICAS", "1",
     "Fleet size floor the autoscaler will not shrink below."),
    ("HVD_TORCH_AUTOSCALE_STABLE_S", "60",
     "Seconds of sustained shrink advice before a scale-down starts."),
    ("HVD_TORCH_AUTOSCALE_STEP", "1",
     "Replicas added or retired per autoscaler action at most."),
    ("HVD_TORCH_BENCH_CACHE", "",
     "Directory of the capacity advisor's serve_load_report.json "
     "(default: the working directory)."),
    ("HVD_TORCH_CONTROLLER_TRANSPORT", "",
     "Native control-plane transport: tcp:<host>:<port> or local:<name>."),
    ("HVD_TORCH_DEVICE_POLL_S", "1.0",
     "Seconds between device memory polls (the HBM gauges)."),
    ("HVD_TORCH_DEVICE_TELEMETRY", "0",
     "Device telemetry plane in ServeEngine (cost model, MFU, HBM)."),
    ("HVD_TORCH_DRAFT_K", "4",
     "Draft tokens proposed per slot per tick when speculation is on."),
    ("HVD_TORCH_ELASTIC_RETRIES", "3",
     "Consecutive elastic.run restarts allowed before giving up."),
    ("HVD_TORCH_EVENT_LOG", "",
     "JSONL request-lifecycle event-log output path."),
    ("HVD_TORCH_EVENT_LOG_MAX_MB", "",
     "Rotate the event log past this many MB, keeping one .1 "
     "generation (unset = unbounded)."),
    ("HVD_TORCH_FLASH_BWD", "kernel",
     "Flash-attention backward: kernel or blockwise (the oracle)."),
    ("HVD_TORCH_LOAD_DURATION_S", "1.0",
     "Seconds of offered arrivals per saturation-sweep rung."),
    ("HVD_TORCH_LOAD_LADDER", "",
     "Comma-separated offered-RPS rungs for the saturation sweep."),
    ("HVD_TORCH_LOAD_PROCESS", "poisson",
     "Load-harness arrival process: poisson, bursty, or fixed."),
    ("HVD_TORCH_LOAD_SEED", "0",
     "Seed for load-harness arrival schedules and request mixes."),
    ("HVD_TORCH_LOAD_TIMEOUT_S", "60",
     "Seconds the load harness waits for late replies per rung."),
    ("HVD_TORCH_MONITOR_PORT", "",
     "Port for the per-rank /metrics + /healthz HTTP exporter."),
    ("HVD_TORCH_NATIVE_CONTROLLER", "auto",
     "Native coordination engine: auto, on, or off."),
    ("HVD_TORCH_PEAK_FLOPS", "",
     "Per-card peak FLOP/s override for the serving-MFU denominator."),
    ("HVD_TORCH_PROFILE", "0",
     "Per-tick phase profiling in ServeEngine (serve.phase.* metrics)."),
    ("HVD_TORCH_PROFILE_WINDOW", "256",
     "Ticks in the profiler's rolling per-phase report window."),
    ("HVD_TORCH_RETRACE_FATAL", "0",
     "Raise when a device program sees a second argument signature."),
    ("HVD_TORCH_ROUTER_JOURNAL", "",
     "Path of the crash-durable request-journal JSONL WAL (unset = off)."),
    ("HVD_TORCH_ROUTER_POLICY", "prefix_affinity",
     "RouterServer policy: round_robin, least_loaded, or prefix_affinity."),
    ("HVD_TORCH_ROUTER_POLL_S", "0.05",
     "Seconds between router polls of replica health and snapshots."),
    ("HVD_TORCH_ROUTER_PORT", "",
     "Port for the RouterServer HTTP front door (maybe_start_router)."),
    ("HVD_TORCH_SAMPLE_S", "1.0",
     "Seconds between time-series samples of the registry (<= 0 = off)."),
    ("HVD_TORCH_SCHED_POLICY", "fifo",
     "ServeEngine scheduler policy: fifo, priority, or edf."),
    ("HVD_TORCH_SIM_REPLICAS", "200",
     "Simulated replica count for the default simfleet campaign."),
    ("HVD_TORCH_SIM_REQUESTS", "100000",
     "Offered virtual request count for the default simfleet campaign."),
    ("HVD_TORCH_SIM_SEED", "0",
     "Seed for the simfleet campaign (schedule, chaos, per-replica "
     "jitter)."),
    ("HVD_TORCH_SLO_E2E_S", "0",
     "End-to-end latency SLO in seconds for goodput (0 = no SLO)."),
    ("HVD_TORCH_SPEC", "0",
     "Self-drafting (prompt-lookup) speculative decode in ServeEngine."),
    ("HVD_TORCH_STRAGGLER_WARN_S", "1.0",
     "Step-lag threshold in seconds before a straggler warning."),
    ("HVD_TORCH_TP", "1",
     "Tensor-parallel degree of ServeEngine (cards per serving replica)."),
    ("HVD_TORCH_TRACE_SAMPLE", "0",
     "Fraction of requests head-sampled into the causal tracing plane."),
    ("HVD_TORCH_TRACE_SEED", "0",
     "Seed for the deterministic trace sampler and span-id derivation."),
    ("HVD_TORCH_VERIFY_BLOCKS", "0",
     "Walk paged-KV block tables every serve tick (debug, slow)."),
)

Knob = collections.namedtuple("Knob", ("name", "default", "help"))


def knobs() -> tuple[Knob, ...]:
    """The registry as named tuples, sorted by name."""
    return tuple(Knob(*row) for row in ENV_KNOBS)


def render_markdown_table() -> str:
    """The knob table in Markdown (README's port section quotes it)."""
    lines = ["| Knob | Default | Meaning |", "| --- | --- | --- |"]
    for k in knobs():
        default = f"`{k.default}`" if k.default else "*(unset)*"
        lines.append(f"| `{k.name}` | {default} | {k.help} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(render_markdown_table())

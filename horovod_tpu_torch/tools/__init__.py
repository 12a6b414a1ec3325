"""Port twins of the repo's ``tools/`` scripts that import the JAX package.

Run them as ``python -m horovod_tpu_torch.tools.<name>``: ``device_report``,
``trace_report``, ``chaos_run``, ``simfleet_run`` and ``perf_gate``.  The
stdlib readers (``tools/load_report.py``, ``health_report.py``,
``router_report.py``, ``profile_report.py``) import nothing of either
package and read the port's files as they are.
"""

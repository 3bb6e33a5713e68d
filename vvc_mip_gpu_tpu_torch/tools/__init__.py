"""The port's measurement tools, each runnable as
``python -m vvc_mip_gpu_tpu_torch.tools.<name>``: the power tracer and
the energy analysis of a CLI run (``power_tracer``, ``compute_energy``),
the analytic roofline with the H100's rates (``roofline``, the op model
that chip_smoke.py's bounds use) and the multi-device scaling report
(``scaling_report``)."""

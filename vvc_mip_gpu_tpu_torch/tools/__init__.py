"""The port's measurement tools, each runnable as
``python -m vvc_mip_gpu_tpu_torch.tools.<name>``: the power tracer and
the energy analysis of a CLI run (``power_tracer``, ``compute_energy``),
the analytic roofline with the H100's rates (``roofline``, the op model
that chip_smoke.py's bounds use), the multi-device scaling report
(``scaling_report``), the host CPU's filtering sweep against the NumPy
golden filters (``profile_cpu_filtering``), the in-context per-class,
leave-one-out and batch-size profiler of the search
(``profile_incontext``), the example frame-CSV writer
(``make_example_frames``), the decisions-CSV diff without pandas
(``diff_decisions``) and the card's idle time in a profile, summed by
the port's spans (``idle_by_span``)."""

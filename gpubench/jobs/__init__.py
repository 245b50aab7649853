"""Job kinds, one module each, found by the name a workload file gives
under ``kind``.  A kind has ``prepare(config, workload, device,
rehearse)``, ``run(prep, draw, rec)`` (one job; returns its ``pairs``,
each pair's ``converged``, what the check keeps and, optionally,
``host_s``, seconds of host-only work the same in every job) and
``check(prep, kept, device, control=False)`` (the numbers compared, by
name)."""

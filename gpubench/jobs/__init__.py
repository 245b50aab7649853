"""Job kinds, one module each, found by the name a workload file gives
under ``kind``.  A kind has ``prepare(config, workload, device,
rehearse)``, ``run(prep, draw, rec)`` (one job; returns its ``pairs``,
each pair's ``converged``, what the check keeps and, optionally,
``host_s``, seconds of host-only work the same in every job) and
``check(prep, kept, device, control=False)`` (the numbers compared, by
name).

The contract a kind keeps, so that the harness's tests hold it to every
fault and to the lower-precision control with no edit of theirs:

- its jobs reach the port's solver only through ``solver.solve`` or
  ``solver.solve_batched``, called as attributes of the module
  ``emg3d_tpu_torch.solver``, directly or through ``Simulation``,
  ``time`` or ``diff`` (not through the names the package re-exports,
  ``emg3d_tpu_torch.solve``): the tests plant their faults there, in
  every Field either entry returns;
- its ``check`` returns ``residual`` and ``residual_gap`` over every
  pair of every job it keeps: the largest relative residual of the
  reference, and its largest distance from the relative residual the
  solve reported for that pair (a batch's per-lane ``rel_error``).
"""

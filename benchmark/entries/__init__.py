"""The entries: how a request of a cell calls the program.

A workload file names its entry (``entries/<entry>.py``).  Each entry
module has four functions, which the harness calls:

* ``setup(ctx)`` -> run: the work that depends only on the protocol
  (the prior, the seeding plans, the spectral constants, the template
  optimum), from ``ctx.config``, ``ctx.mix`` (the traffic mix), ``ctx.pool``
  (the generated grids, on ``ctx.device``) and ``ctx.kernels`` (the
  ``KernelSet`` every call into the program takes as ``kernels=``);
* ``request(run, grid)`` -> out: one request on a pool grid through
  ``run``, returned when its results are where the request says they end;
* ``failed(out)`` -> bool: the request returned non-finite maps or
  spectra;
* ``record(grid, out)`` -> the outputs in the comparison's form
  (``reference/check.py``): ``inputs`` (the grid), and whichever of
  ``recon`` (planes), ``spectra`` (planes), ``phases`` (p0, p1, pivot) and
  ``fit`` (``x`` (B, K, 4) amplitude, shift, linewidth, phase; ``converged``;
  ``cost``, ``sds`` or ``crlb_pct`` where the program gives them) it made.

Every call into the program goes through a module attribute looked up at
call time, so that a traced run's spans (``metrics/``) can wrap it.
"""

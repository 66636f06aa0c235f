"""Plain references of the configurations, one module per ``reference``
name a configuration file gives. Each module imports torch and numpy only,
nothing of the program, and provides:

* ``STATEFUL``: whether a record depends on the block before it;
* ``record(block, prev, cfg) -> np.ndarray``: the exact record of ``block``
  (a wire ``(ndf, nchk * 3584)`` int16 tensor) after ``prev`` (the stream's
  previous block, or None at its start);
* ``control(cfg)``: the same computation in the next precision down, as a
  step the executor takes in the program's place (``PowerPipeline``'s
  ``power_fn``).
"""

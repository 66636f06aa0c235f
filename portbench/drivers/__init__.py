"""Traffic drivers, one module per ``driver`` name a traffic file gives.

A driver module has ``setup(cfg, traffic, seed, device, step, trace) ->
session``. ``step`` is None for the program's own step, or a step to run
in its place (``PowerPipeline``'s ``power_fn``: the control, or a fault in
the tests). ``setup`` makes the pool, builds the executor and runs the warm
prefix. The session then has:

* ``window(seconds, clock)``: open ``clock``, drive the traffic for
  ``seconds``, stop sending, wait for every record due, close ``clock``;
* ``streams``: the ``stream.Stream`` of each executor state;
* ``pool_block(i)``: pool block ``i`` on the device, for the reference;
* ``close()``: free the program's state (pinned and device slots, pools
  the reference does not need).
"""

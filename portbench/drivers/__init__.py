"""Traffic drivers, one module per driver, found by the name a traffic file
gives. A driver module defines ``Driver(cfg, traffic, seed, device,
tracer)`` with ``setup()``, ``window(seconds)``, ``release()``,
``check(limits)`` and ``context()``; see ``portbench.run``."""

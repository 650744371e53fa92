"""Serving subsystem of the port.

* ``engine``    -- ForecastEngine: continuous-batching autoregressive
                   field-rollout serving on one device.
* ``scheduler`` -- host-side microbatch policy (a copy of the reference's).
* ``step``      -- language-model prefill and greedy decode (``generate``).
"""
from repro_torch.serve.engine import ForecastEngine, ServeConfig  # noqa: F401
from repro_torch.serve.scheduler import (ForecastResult,  # noqa: F401
                                         MicrobatchScheduler)

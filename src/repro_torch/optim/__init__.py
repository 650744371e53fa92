"""Adam with global-norm clipping and f32 masters, and the LR schedule,
written by hand as the reference's ``repro/optim`` is."""

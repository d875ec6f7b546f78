"""Device ms a step of the loss (both towers' forward and the contrastive
loss): the mean of the window's steps' ``wise.train.forward`` spans in the
port (CUDA events around that phase of CLIPTrainer.train_step). The window
is the traced one, so the time holds the profiler's slowdown of this
launch-bound step (most in the backward and the optimizer): compare it
between traced runs only."""

from h100bench import program_spans


def read(r):
    dev = program_spans.device_seconds("wise.train.forward", r.get("steps"))
    return 1e3 * sum(dev) / len(dev) if dev else None

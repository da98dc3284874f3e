"""output_tok_s (tokens/s): output tokens emitted in the window, by every
request, over the window's seconds."""
from h100bench import window


def read(run):
    return window.output_tokens(run.drive.tracked, run.t0, run.t1) / run.seconds

"""setup.warmup_wait_s: seconds the first two jobs wait for the thread
that brings the card up (context, kernel library, first launches) to
end before pass 2 (the program's ``warmup.join`` spans), summed; part of
``setup_s``.  Nothing where no job waited."""

from benchmark import program_spans


def read(trace):
    spans = program_spans.before_window(trace)
    if not spans or not any(s.name == "warmup.join" for s in spans):
        return None
    return program_spans.seconds(spans, "warmup.join")

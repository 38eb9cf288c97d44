"""Host milliseconds a frame inside `Engine.process_frame` (host engine:
engine.Engine + graphs.CompiledStep), from the call to its return, over
the window's frames."""


def read(rec, cell):
    if not rec.engine_calls:
        return None
    return rec.engine_host_s / rec.engine_calls * 1e3

"""Device milliseconds of one batched step of every lane
(parallel.BatchEngine): CUDA events around each process_chunk, the total
over the chunks' frames."""


def read(rec, cell):
    if not rec.lane_steps:
        return None
    return rec.lane_step_s / rec.lane_steps * 1e3

"""robust_gn.HOST_READS over the window, a frame (host engine): the loop
flags the host read back."""


def read(rec, cell):
    if not rec.window_frames:
        return None
    return rec.host_reads / rec.window_frames

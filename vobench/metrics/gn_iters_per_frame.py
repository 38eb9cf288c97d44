"""Stage 5's Gauss-Newton iterations a frame: StepResult.num_it (the
initial solve's; num_it_final, the refit's, is not added), over every frame
after set-up, all lanes."""


def read(rec, cell):
    its = [n for lane in range(rec.lanes) for n in rec.num_it[lane][rec.warm:]]
    return sum(its) / len(its) if its else None

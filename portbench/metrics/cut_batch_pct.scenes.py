"""cut_batch_pct.scenes (%): the batches that ``run_file`` cut short at
a config switch (the program's ``switch_cuts`` counter) over all its
batches (``batches``), in the traced window."""

from portbench.switch_spans import cut_pct


def read(rec):
    return cut_pct(rec)

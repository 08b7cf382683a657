"""attention_fill.din (%; layer: attention units): the share of the rows
that DIN's attention MLPs computed which are real history positions, not
padding, over the run's untraced window: the port's device counter
(``recsys_tpu_torch/models/din.py`` ``meta['attention_counter']``, summed on
the card and read before and after the window). Nothing read where the port
counts nothing."""


def read(s: dict):
    counts = s.get("attention_counts")
    if not counts or not counts["rows"]:
        return None
    return 100.0 * counts["real"] / counts["rows"]

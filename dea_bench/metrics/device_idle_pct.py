"""device_idle_pct: the share of the traced stretch's wall in which no
kernel, copy or fill ran on the card, 100 x (1 - busy / wall)."""

SPANS = ()
COUNTS = ()


def read(tr):
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

"""The share (%) of the traced stretch in which no device op (kernel, copy,
memset) ran: 1 - the union of their intervals over the stretch's wall
time."""


def read(view, iterations):
    return view.idle_pct()

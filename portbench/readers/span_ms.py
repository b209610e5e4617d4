"""Device milliseconds per iteration of one of the program's host ranges
(``record_function``): the union of the intervals of the device ops
launched while the range ``span`` was open, summed over its instances in
the traced stretch, over the iterations there."""


def read(view, iterations, span):
    s = view.range_device_s(span)
    if s is None or iterations == 0:
        return None
    return 1e3 * s / iterations

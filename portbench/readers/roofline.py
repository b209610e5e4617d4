"""Hand-written kernels' share (%) of their roofline: over every call of the
functions ``kernels`` of the program's module ``module`` in the traced
stretch, the sum of each call's least time (``roofline.bound_of_call``,
with the work counted from the call's shapes by ``counts/<count>.py``, the
count that ``kernels`` maps the function to) over the sum of the device
time of the ops the calls launched.  The work is counted from shapes
alone, so it reads the same whatever form of the kernel runs."""

from portbench import roofline


def wraps(module, kernels):
    return [(module, k) for k in kernels]


def read(view, iterations, module, kernels):
    least = spent = 0.0
    for fn, count in kernels.items():
        for shapes, dtype, sec in view.calls(fn):
            least += roofline.bound_of_call(count, shapes, dtype)
            spent += sec
    if spent <= 0:
        return None
    return 100.0 * least / spent

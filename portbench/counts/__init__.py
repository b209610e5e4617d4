"""A kernel's work from the shapes of its tensor arguments, found by name:
``counts/<count>.py`` exposes ``work(shapes, dtype)`` -> (operations,
bytes), ``shapes`` the tuple of the arguments' shapes as ``traces.wrap``
records them."""

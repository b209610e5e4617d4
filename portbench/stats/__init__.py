"""Statistics of a measured window, found by name: ``stats/<stat>.py``
exposes ``value(setup_s, window, **params)``, and an end-to-end metric's
file ``end_to_end/<metric>.json`` names its ``stat`` and gives the
``params``.  ``window`` holds ``iterations`` and ``solve_s`` (one entry
per solve, in order) and ``window_s``."""

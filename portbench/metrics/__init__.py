"""One reader per per-layer metric: ``metrics/<name>.py`` defines
``read(trace) -> float | None``.  A name ``<part>_<family>`` with no file
of its own is read by ``metrics/<family>.py`` as ``read(trace, part)``
(``blur_roofline``: ``metrics/roofline.py`` with ``"blur"``).  A reader
that finds nothing to read returns None, and the metric is left out of the
result's line."""

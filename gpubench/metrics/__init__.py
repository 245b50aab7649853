"""One reader per metric, found by the metric's name: ``read(run)``
returns the metric's value from what the run recorded, or None where
there is nothing to read (the metric is then left out of the line).
``run`` has ``jobs``, ``pairs``, ``window_s``, ``setup_s``,
``window_peak_bytes`` and, in a traced run, ``recorder`` (the spans'
host seconds, each solve's ``it_mg``, each smoothing call's shapes)
and ``trace`` (:func:`gpubench.spans.reduce_trace`)."""

"""One reader per metric: ``UNIT`` and ``read(run)``, found by file name."""

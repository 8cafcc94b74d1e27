"""The harness: the cell's files (``spec``), one run (``runner``), the
yardstick (``work``), the device trace (``devtrace``), ``correct``
(``judge``) and the guard against JAX (``guard``)."""

"""The benchmark's machinery: the cell's files (``spec``), its inputs
(``data``), the run (``runner``), the profiler trace (``trace``) and the
comparisons that decide ``correct`` (``compare``)."""

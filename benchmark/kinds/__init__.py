"""The kinds of job a traffic mix runs, one module each (``jobs.kind``)."""

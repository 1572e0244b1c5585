"""Data input and output of the port: ``png`` reads and writes PNG files
without PIL; ``datasets``, ``np_ops``, ``loader`` and ``prefetch`` are the
training and validation data pipeline on numpy and the standard library."""

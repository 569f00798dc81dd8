"""The plain reference the port's outputs are judged against.

Plain NumPy and PyTorch: ``parse`` reads the generated inputs, ``count``
counts their canonical k-mers, ``formats`` holds frozen readers of the
``.hist``, ``.ktab`` and ``.prof`` files (and a ``.ktab`` writer for the
inputs of ``-p:`` jobs), and ``compare`` turns the two sides into the numbers
that decide ``correct``. Nothing here imports the port or takes anything the
port made, except the output files it judges.
"""

"""On-disk file formats of the FastK ecosystem (.hist/.ktab/.prof/.pidx).

Byte-layouts follow the reference spec (reference: README.md "File Encodings",
writers in count.c:1893-1910, table.c:488-504, merge.c:761-1006 and readers in
libfastk.c). All integers are little-endian (the reference writes native x86).
"""

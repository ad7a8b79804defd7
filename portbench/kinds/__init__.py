"""Request kinds, one module each, found by the ``kind`` of a cell file.
A kind module defines ``Kind`` (see ``base.py``)."""

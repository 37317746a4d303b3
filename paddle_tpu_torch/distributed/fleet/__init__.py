"""Elastic supervision of training processes (``elastic.py``)."""

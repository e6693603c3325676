"""Frozen operation and byte counts, one module per layer, from shapes alone.

They count what a layer's function needs, whatever kernel implements it:
a roofline share or an ``mfu`` computed from them reads the same work on
every route, and cannot pass 100% unless the device time leaves out part
of the work. ``peaks`` holds the data-sheet rates they are divided by.
"""

"""Tools of the port: the study and release tools, the data-preparation
chain, and measurement scripts (those need a GPU)."""

"""Multi-head ensemble: shared and dense layouts, aggregation and decision rule."""

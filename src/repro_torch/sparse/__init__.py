"""Block-sparse ternary weights (port of ``repro/sparse``): the padded pool
format the serving step can carry per stacked layer, and the density
profiling that drives the sparse dispatch."""

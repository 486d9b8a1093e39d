"""Analysis figures (ref create_figures/): cohort stats, training curves,
model comparison.  Pure matplotlib/pandas; imported lazily so the compute
path never depends on plotting."""

"""One driver per kind of traffic (train, bulk, serve). A traffic mix names
its driver and gives it parameters (gpubench/traffic/<mix>.json); a new mix
of a known kind is a data file alone."""

"""Planning helpers: the analytic cost model of the discovery pipeline."""

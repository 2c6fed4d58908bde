"""Entry points and planning helpers: the drivers, the analytic cost models
and the device-free dry run."""

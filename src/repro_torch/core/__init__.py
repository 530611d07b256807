"""The scheduler's analytic core (the counterpart of ``repro.core``)."""

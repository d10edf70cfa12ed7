"""Small shared utilities (the port's counterpart of ``repro.utils``)."""

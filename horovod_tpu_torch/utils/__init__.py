"""Environment knobs of the port."""

"""Device ops of the scheduling round (torch) and their host halves."""

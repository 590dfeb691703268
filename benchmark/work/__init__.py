"""Work counts for the rooflines, one file an operation, from the scene."""

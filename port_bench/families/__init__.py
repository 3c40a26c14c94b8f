"""The modules of the configurations' families, found by name from a
configuration file's ``family``: each builds the port's side and the plain
reference's side from the configuration and the seed, runs what a cell's
loop asks of it, and counts its model's operations from shapes."""

"""Work counts of the chain that do not depend on which kernel does it."""

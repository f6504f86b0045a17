"""A frozen copy of the port's module math (MGAR's models, losses and optimizer),
every hand-written kernel wrapper taking its plain version on any device: the
benchmark's plain reference. It imports nothing outside this package."""

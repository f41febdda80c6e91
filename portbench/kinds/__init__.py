"""The generator, window and check of each kind of traffic, found by the kind's name."""

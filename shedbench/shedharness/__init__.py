"""The harness of the shed-step benchmark: finds a cell by name, makes
its inputs, drives the program through the measured window, reads the
trace and decides ``correct`` against ``yardstick.reference``."""

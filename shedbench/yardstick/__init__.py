"""The benchmark's yardstick: what a change to the program may not move.

``traffic`` (the frozen scene generator), ``counting`` (the ingest's
least bytes and operations, from shapes), ``peaks`` (the card's published
rates) and ``reference`` (the plain reference that decides ``correct``).
None of them imports the program.
"""

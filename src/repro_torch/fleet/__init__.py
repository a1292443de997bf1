"""Serving-fleet policy shared by the serve loop and the live index.

`retry` (the bounded retry budget, a copy of the JAX package's) and, from
`faults`, only the commit-failure exception the live index and the serve
loop name.  Fault injection itself comes with the fleet slice.
"""

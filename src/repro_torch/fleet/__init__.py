"""Serving-fleet policy shared by the serve loops and the live index.

`retry` (the bounded retry budget) and `faults` (the seeded fault plan, its
injector and the commit-failure exception), both copies of the JAX
package's.  Replica groups and recovery come with the fleet slice.
"""

"""The three kinds of traffic: an HTTP closed loop against the served
engine, batched library searches, and back-to-back index builds. A traffic
file names its driver; the harness loads it by that name."""

"""The port's utilities: ``checkpoint`` (reading and writing the JAX
package's flax files), ``logging_util`` (the training log), ``profiling``
(step timing and traces), ``visualization`` (the summaries' panels and
histograms) and ``matlab_export`` (the ``.mat`` records)."""

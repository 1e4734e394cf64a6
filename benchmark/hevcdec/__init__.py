"""A frozen copy of the decoder of `hevc_tpu_torch` (its `decoder/`
package and the modules that it reads, with the native CABAC parser,
deblocking filter and SAO of `entropy/native/`), the benchmark's own:
the encoder under test may change, this copy does not. It imports
nothing of the encoder.

Departures from the copied code: the device halves of `ops/quant.py`,
`ops/transform.py` and `ops/intra.py` and the numpy deblocking filter
are left out (the native filter is the one that runs); the native library is the one built in this directory
(no library named by the environment, no sanitizer build); and
`decoder.top.DecoderTop` takes `given` pictures (parsed for their syntax
and motion, their samples taken as given, not reconstructed) and
`drop_bits` (every sample kept at a lower precision).
"""

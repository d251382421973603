"""bthread — M:N tasklets, butex, correlation ids, timers and CUDA-event
completion waits (reference: src/bthread/)."""

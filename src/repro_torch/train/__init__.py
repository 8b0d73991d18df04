# Training stack of the port: checkpoints in the reference's file format
# (checkpoint), AdamW and its schedules (optimizer), the language model's
# and the cascade scorer's train steps (step), the fault-tolerant
# training loop (fault), compressed data-parallel gradients (compression) and GPipe
# pipeline parallelism (pipeline_parallel).

# Training stack of the port: checkpoints in the reference's file format
# (checkpoint), AdamW and its schedules (optimizer), the cascade scorer's
# train step (step).

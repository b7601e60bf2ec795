"""The traffic loops, one module each: a traffic file's `loop` names the
module here whose `run(ctx)` drives one run (generator.py, harness.py)."""

"""Microbatch schedules (gradient accumulation so far)."""

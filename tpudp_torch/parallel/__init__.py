"""Data-parallel gradient synchronization over ``torch.distributed``: the
sync ladder, the hand-rolled all-reduce schedules and error-feedback
int8 compression."""

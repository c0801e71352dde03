"""Admission control: request deadlines (`controller`)."""

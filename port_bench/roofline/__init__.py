"""The yardstick's arithmetic: published peaks and each kernel's work."""

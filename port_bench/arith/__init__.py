"""The yardstick's arithmetic: the card's published peaks and each kernel's
and step's operations and bytes, computed from shapes."""

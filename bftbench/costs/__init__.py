"""Operations and bytes of kernels, and the peaks of the card."""

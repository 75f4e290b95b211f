import sys

if "--front" in sys.argv[1:]:
    # the admission front imports no kernel and no torch: route before
    # the serve node's modules load
    from ingress_plus_tpu_torch.serve.front import main
else:
    from ingress_plus_tpu_torch.serve.server import main

if __name__ == "__main__":
    main()
